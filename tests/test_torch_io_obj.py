"""The OBJ + MTL loader of the port against the JAX package's.

One file with quads and a pentagon (fan triangulation), negative
indices, faces without ``vn`` or without ``vt``, three ``usemtl`` groups
and faces before any, and an MTL with ``Kd``, ``Ns``, ``illum``, ``d``,
``Tr`` and ``Ke``: through the native tokenizer and through Python, the
arrays are exact and the material dicts equal to JAX's, and the two
tokenizers agree. The native library is built under ``build/native/``;
``native/`` is left as it is. A ``map_Kd`` line makes ``MaterialArray.build``
raise in both packages, as JAX's viewer does.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from bifrost3d_tpu.io import obj as jobj
from bifrost3d_tpu.scene.materials import MaterialArray as JaxMaterials

from bifrost3d_tpu_torch.io import native_obj, obj as tobj
from bifrost3d_tpu_torch.scene.materials import MaterialArray
import torch_parity  # noqa: F401  (one torch thread per test worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MTL = """# three materials
newmtl red
Kd 0.8 0.1 0.1
Ns 50
illum 2
d 0.75
newmtl chrome
Kd 0.9 0.9 0.9
Ns 800
illum 3
newmtl glow
Kd 0.2 0.2 0.2
Ke 4 3 2
Tr 0.25
illum 5
newmtl unused
Kd 0.1 0.2 0.3
Ke 0 0 0
"""

OBJ = """# a test object
mtllib scene.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 1.5 0.25
v 2 0 1
v 2 1 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0 0.6 0.8
f 1 2 3
usemtl red
f 1/1/1 2/2/1 3/3/2 4/4/2
f -7/-4/-2 -6/-3/-2 -3/-2/-1
usemtl chrome
f 1//1 2//1 6//2 7//2 3//1
usemtl glow
f 2/1 6/2 7/3
f -6/-3 -1/-2 -5/-1
usemtl red
f 4/4/1 3/3/1 5/1/2
"""


def _write(tmp_path, mtl=MTL):
    (tmp_path / "scene.mtl").write_text(mtl)
    path = tmp_path / "scene.obj"
    path.write_text(OBJ)
    return str(path)


_WRITES = """
import os, sys
from bifrost3d_tpu_torch.io import native_obj
written = []

def hook(event, args):
    if event == "open" and (args[1] and any(c in args[1] for c in "wax+")
                            or isinstance(args[2], int) and args[2] & (
                                os.O_WRONLY | os.O_RDWR | os.O_CREAT)):
        written.append(str(args[0]))
    elif event in ("os.replace", "os.rename"):
        written.append(str(args[1]))
    elif event == "subprocess.Popen":
        argv = [str(a) for a in args[1]]
        written.extend(argv[i + 1] for i, a in enumerate(argv[:-1])
                       if a == "-o")
sys.addaudithook(hook)
assert native_obj.native_available()
raw = native_obj.parse_obj_native(sys.argv[1])
assert raw["material_names"] == ["red", "chrome", "glow"], raw
native = os.path.join(native_obj.REPO_DIR, "native") + os.sep
bad = [p for p in written if os.path.abspath(p).startswith(native)]
assert not bad, bad
assert native_obj.library_path().startswith(
    os.path.join(native_obj.REPO_DIR, "build", "native") + os.sep)
assert "jax" not in sys.modules and "bifrost3d_tpu" not in sys.modules
print(written)
"""


def _assert_same(got, ref):
    meshes, mats = got
    ref_meshes, ref_mats = ref
    assert mats == ref_mats
    assert len(meshes) == len(ref_meshes)
    for (mesh, idx, name), (ref_mesh, ref_idx, ref_name) in zip(meshes,
                                                               ref_meshes):
        assert (idx, name) == (ref_idx, ref_name)
        for field in ("indices", "positions", "normals", "texcoords"):
            a, b = getattr(mesh, field), getattr(ref_mesh, field)
            assert (a is None) == (b is None), field
            if a is not None:
                assert a.dtype == np.asarray(b).dtype, field
                np.testing.assert_array_equal(a, np.asarray(b), field)


def test_native_library_builds_under_build_only(tmp_path):
    """In a fresh interpreter, building (if not built yet) and running the
    native tokenizer writes nothing under ``native/`` (every file opened
    for writing, renamed into place or named by g++'s ``-o`` is watched)
    and imports nothing of JAX; the library lies under ``build/native/``."""
    path = _write(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _WRITES, path], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert os.path.exists(native_obj.library_path())
    raw = native_obj.parse_obj_native(path)
    assert raw["mtllib"] == "scene.mtl"


@pytest.mark.parametrize("use_native", [True, False])
def test_load_obj_matches_jax(use_native, tmp_path):
    path = _write(tmp_path)
    got = tobj.load_obj(path, use_native=use_native)
    _assert_same(got, jobj.load_obj(path, use_native=use_native))
    meshes, mats = got
    # Default group, red, chrome, glow: quads and the pentagon fanned.
    assert [name for _, _, name in meshes] == ["default", "red", "chrome",
                                               "glow"]
    assert [m.indices.shape[0] for m, _, _ in meshes] == [1, 4, 3, 2]
    assert meshes[0][0].normals is None and meshes[0][0].texcoords is None
    assert meshes[2][0].texcoords is None and meshes[2][0].normals is not None
    assert meshes[3][0].normals is None and meshes[3][0].texcoords is not None
    assert mats[1]["coverage"] == 0.75 and "metallic" not in mats[1]
    assert mats[2]["metallic"] == 1.0
    assert mats[3]["emission"] == (4.0, 3.0, 2.0)
    assert mats[3]["coverage"] == 0.75 and mats[3]["metallic"] == 1.0


def test_tokenizers_agree(tmp_path):
    path = _write(tmp_path)
    _assert_same(tobj.load_obj(path, use_native=True),
                 tobj.load_obj(path, use_native=False))


def test_missing_mtl_gives_default_materials(tmp_path):
    path = _write(tmp_path)
    os.remove(tmp_path / "scene.mtl")
    for use_native in (True, False):
        got = tobj.load_obj(path, use_native=use_native)
        _assert_same(got, jobj.load_obj(path, use_native=use_native))
        assert all(m == dict(tint=(0.8, 0.8, 0.8), roughness=0.8)
                   for m in got[1])


def test_map_kd_makes_the_material_table_raise(tmp_path):
    """``map_Kd`` is kept as a path string, and ``MaterialArray.build``'s
    finiteness check rejects it: JAX's viewer raises on such a file, and so
    does the port's."""
    path = _write(tmp_path, MTL + "newmtl tex\nmap_Kd wood.png\nmap_d a.png\n")
    with open(path, "a") as f:
        f.write("usemtl tex\nf 1 2 3\n")
    got = tobj.load_obj(path)
    _assert_same(got, jobj.load_obj(path))
    assert got[1][-1]["tint_texture_path"] == "wood.png"
    assert got[1][-1]["coverage_texture_path"] == "a.png"
    with pytest.raises(ValueError):
        JaxMaterials.build(got[1])
    with pytest.raises(ValueError):
        MaterialArray.build(got[1], device="cpu")
