"""ctypes binding to the native OBJ tokenizer (``native/obj_parser.cpp``).

Port of ``bifrost3d_tpu/io/native_obj.py``. The shared library is compiled
with ``g++ -O2`` at first use into ``build/native/`` at the repository
root, named by a hash of the source and the flags and moved into place
atomically, as the BVH builder's (:mod:`bifrost3d_tpu_torch.geometry.native`);
nothing is written beside the source. Where it cannot be built a warning
says so and :func:`parse_obj_native` returns None: ``io/obj.load_obj`` then
tokenizes in Python. Both give the same arrays; the grouping and material
rules stay in ``io/obj`` for both.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import warnings

import numpy as np

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(REPO_DIR, "native", "obj_parser.cpp")
BUILD_DIR = os.path.join(REPO_DIR, "build", "native")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_ip = ctypes.POINTER(ctypes.c_int)
_fp = ctypes.POINTER(ctypes.c_float)


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode()
                                ).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libobj_parser_{digest}.so")


def build() -> str:
    """Compile the tokenizer unless its library exists → the .so path."""
    out = library_path()
    if os.path.exists(out):
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([gxx, *GXX_FLAGS, SOURCE, "-o", tmp], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, out)   # atomic: concurrent builders both succeed
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.lru_cache(maxsize=None)
def _load():
    """The loaded library, or None (with a warning) when it cannot be
    built."""
    try:
        lib = ctypes.CDLL(build())
    except (OSError, RuntimeError, subprocess.CalledProcessError) as e:
        warnings.warn(f"native OBJ parser unavailable ({e}); using Python")
        return None
    lib.bifrost_obj_parse.restype = ctypes.c_int
    lib.bifrost_obj_parse.argtypes = [
        ctypes.c_char_p, _ip, _ip, _ip, _ip, _ip, _ip, _ip]
    lib.bifrost_obj_fetch.restype = ctypes.c_int
    lib.bifrost_obj_fetch.argtypes = [
        ctypes.c_int, _fp, _fp, _fp, _ip, _ip, ctypes.c_char_p,
        ctypes.c_char_p]
    lib.bifrost_obj_free.restype = ctypes.c_int
    lib.bifrost_obj_free.argtypes = [ctypes.c_int]
    return lib


def native_available() -> bool:
    return _load() is not None


def parse_obj_native(path: str):
    """→ dict with positions [P,3], normals [N,3] or None, uvs [U,2] or
    None, tri_corners [T,3,3] int32 (pos/uv/normal, -1 = absent),
    tri_material [T] int32 (-1 = before any usemtl), material_names
    [str...], mtllib str. Returns None if the native library is missing."""
    lib = _load()
    if lib is None:
        return None
    counts = [ctypes.c_int(0) for _ in range(7)]
    handle = lib.bifrost_obj_parse(
        path.encode("utf-8"), *[ctypes.byref(c) for c in counts])
    if handle < 0:
        raise FileNotFoundError(path)
    n_pos, n_n, n_uv, n_tri, _n_mat, names_len, mtllib_len = \
        [c.value for c in counts]
    positions = np.empty((max(n_pos, 1), 3), np.float32)
    normals = np.empty((max(n_n, 1), 3), np.float32)
    uvs = np.empty((max(n_uv, 1), 2), np.float32)
    tri_corners = np.empty((max(n_tri, 1), 3, 3), np.int32)
    tri_material = np.empty((max(n_tri, 1),), np.int32)
    names_buf = ctypes.create_string_buffer(max(names_len, 1))
    mtllib_buf = ctypes.create_string_buffer(max(mtllib_len, 1))
    rc = lib.bifrost_obj_fetch(
        handle, positions.ctypes.data_as(_fp), normals.ctypes.data_as(_fp),
        uvs.ctypes.data_as(_fp), tri_corners.ctypes.data_as(_ip),
        tri_material.ctypes.data_as(_ip), names_buf, mtllib_buf)
    lib.bifrost_obj_free(handle)
    if rc != 0:
        raise RuntimeError(f"native OBJ fetch failed for {path}")
    names = names_buf.raw[:names_len].decode("utf-8").split("\n")[:-1] \
        if names_len else []
    return dict(
        positions=positions[:n_pos],
        normals=normals[:n_n] if n_n else None,
        uvs=uvs[:n_uv] if n_uv else None,
        tri_corners=tri_corners[:n_tri],
        tri_material=tri_material[:n_tri],
        material_names=names,
        mtllib=(mtllib_buf.raw[:mtllib_len].decode("utf-8")
                if mtllib_len else ""),
    )
