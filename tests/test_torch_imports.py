"""Import hygiene of the PyTorch port, and chip_smoke.py's refusals.

The port imports torch and numpy only: importing every one of its modules
in a fresh interpreter must bring in neither ``jax`` nor the JAX package
``bifrost3d_tpu`` (which would also switch on its compile cache), nor
``triton``. chip_smoke.py must refuse to run without a CUDA card and
outside a checkout of the repository.
"""

import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import bifrost3d_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "bifrost3d_tpu", "triton"))
print(len(names), bad)
assert len(names) >= 72, names
for new in ("apps.smallpt_app", "integrator.smallpt", "integrator.smallvpt",
            "integrator.pallas_smallpt", "scene.spheres", "scene.media",
            "math.morton", "geometry.bvh", "geometry.native",
            "geometry.pallas_bvh", "geometry.pallas_bvh_vmem",
            "geometry.pallas_clustered", "sampling.pmj",
            "math.distribution1d", "math.distribution2d",
            "lights.environment", "io.texture", "diff", "diff.render_grad",
            "diff.edge_grad", "diff.mesh_edge_grad", "utils.tree",
            "io.image", "io.compare", "io.native_obj", "io.obj", "io.gltf",
            "io.pixel_image", "integrator.aov", "apps.simple_viewer",
            "integrator.backend", "utils.checkpoint", "utils.profiling",
            "preview", "preview.renderer", "preview.ibl", "preview.ssao",
            "apps.environment_convolution", "core", "core.uid",
            "core.bitmask", "core.changeset", "core.engine", "core.input",
            "core.compositor", "scene.datamodel",
            "apps.interactive_viewer", "parallel", "parallel.mesh",
            "parallel.render", "parallel.distributed", "math.statistics",
            "math.nelder_mead", "math.geometry2d3d", "math.ltc",
            "shading.ltc_fit", "bsdf.burley_sss", "apps.dev_analysis",
            "utils.hostbuild"):
    assert pkg.__name__ + "." + new in names, new
assert not bad, bad
"""

_NATIVE_BUILD = """
import os, sys
from bifrost3d_tpu_torch.geometry import native
opened = []
sys.addaudithook(lambda event, args: opened.append(str(args[0]))
                 if event == "open" else None)
available = native.native_available()
jax_dir = os.path.join(native.REPO_DIR, "bifrost3d_tpu") + os.sep
bad = [p for p in opened if os.path.abspath(p).startswith(jax_dir)]
print(available, native.library_path(), bad)
assert not bad, bad
assert native.library_path().startswith(os.path.join(native.REPO_DIR, "build"))
assert "jax" not in sys.modules and "bifrost3d_tpu" not in sys.modules
"""


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_neither_jax_nor_the_jax_package():
    proc = _run(["-c", _IMPORT_ALL], REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_native_builder_opens_nothing_of_the_jax_package():
    proc = _run(["-c", _NATIVE_BUILD], REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    proc = _run(["chip_smoke.py"], REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_refuses_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
