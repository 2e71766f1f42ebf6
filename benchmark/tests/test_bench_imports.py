"""What a run loads: never JAX or the JAX package; and the reference
nothing of the port either (top-level module names compared whole)."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark.harness import spec

REFERENCE_DIR = os.path.join(spec.BENCH_DIR, "reference")
NOT_IN_A_RUN = {"jax", "jaxlib", "flax", "bifrost3d_tpu"}
NOT_IN_THE_REFERENCE = NOT_IN_A_RUN | {"bifrost3d_tpu_torch"}


def _loaded_after(code: str) -> set:
    script = (f"import sys; sys.path.insert(0, {spec.ROOT!r})\n{code}\n"
              "print(sorted({m.split('.')[0] for m in list(sys.modules)}))")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def _reference_modules():
    for dirpath, _, files in os.walk(REFERENCE_DIR):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), spec.ROOT)
                yield rel[:-3].replace(os.sep, ".").removesuffix(".__init__")


def test_harness_loads_no_jax():
    """Every module of the harness, every traffic's job, the port's paths
    a job sets up and every metric reader, imported in a fresh process."""
    code = ("import torch\n"
            "from benchmark.harness import cli, spec, profiling, roofline\n"
            "for w in spec.load_benchmark()['workloads']:\n"
            "    c = spec.resolve(w['name'])\n"
            "    spec.job_module(c.traffic)\n"
            "    [spec.metric_reader(m['name']) for m in c.per_layer]\n"
            "import glob, json, os\n"
            "for f in glob.glob(os.path.join(spec.BENCH_DIR, 'traffic', '*.json')):\n"
            "    spec.job_module(json.load(open(f)))\n"
            "for f in glob.glob(os.path.join(spec.BENCH_DIR, 'metrics', '*.py')):\n"
            "    spec.metric_reader(os.path.basename(f)[:-3])\n"
            "import bifrost3d_tpu_torch.integrator.path_tracer\n"
            "import bifrost3d_tpu_torch.integrator.pallas_mesh\n"
            "import bifrost3d_tpu_torch.post.pipeline\n")
    assert not (_loaded_after(code) & NOT_IN_A_RUN)


def test_reference_loads_nothing_of_the_port():
    code = "\n".join(f"import {m}" for m in _reference_modules())
    loaded = _loaded_after(code)
    assert "benchmark" in loaded
    assert not (loaded & NOT_IN_THE_REFERENCE)


@pytest.mark.parametrize("module", list(_reference_modules()))
def test_reference_sources_import_nothing_of_the_port(module):
    path = os.path.join(spec.ROOT, *module.split(".")) 
    path = path + ".py" if os.path.exists(path + ".py") else os.path.join(
        path, "__init__.py")
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            assert n.split(".")[0] not in NOT_IN_THE_REFERENCE, (path, n)
