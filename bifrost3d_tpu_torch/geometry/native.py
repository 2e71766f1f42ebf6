"""ctypes binding to the native C++ BVH builder (``native/bvh_builder.cpp``).

Port of ``bifrost3d_tpu/geometry/native.py``. The shared library is
compiled with ``g++ -O2`` at first use into ``build/native/`` at the
repository root, named by a hash of the source; nothing is written beside
the source. Where no compiler is found the numpy builder of
``geometry/bvh.py`` runs instead and a warning says so: both produce the
same flattened layout (depth-first, left child = parent + 1), so they are
interchangeable, and this is a choice of host-side builder, not of a
kernel.
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
SOURCE = os.path.join(REPO_DIR, "native", "bvh_builder.cpp")
BUILD_DIR = os.path.join(REPO_DIR, "build", "native")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode()
                                ).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libbvh_builder_{digest}.so")


def build() -> str:
    """Compile the builder unless its library exists → the .so path."""
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
        warnings.warn(f"native BVH builder unavailable ({e}); the numpy "
                      "builder runs instead (minutes for large meshes)")
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.bifrost_build_bvh.restype = ctypes.c_int
    lib.bifrost_build_bvh.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_int,
                                      f32p, f32p, i32p, i32p, i32p]
    return lib


def native_available() -> bool:
    return _load() is not None


def build_bvh_native(tri_min: np.ndarray, tri_max: np.ndarray,
                     max_leaf: int = 4):
    """→ (node_min, node_max, node_a, node_count, prim_order) numpy arrays,
    or None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    t = tri_min.shape[0]
    tri_min = np.ascontiguousarray(tri_min, np.float32)
    tri_max = np.ascontiguousarray(tri_max, np.float32)
    cap = max(2 * t, 2)
    node_min = np.zeros((cap, 3), np.float32)
    node_max = np.zeros((cap, 3), np.float32)
    node_a = np.zeros(cap, np.int32)
    node_count = np.zeros(cap, np.int32)
    prim_order = np.zeros(t, np.int32)

    def ptr(a, ty):
        return a.ctypes.data_as(ctypes.POINTER(ty))

    n = lib.bifrost_build_bvh(
        ptr(tri_min, ctypes.c_float), ptr(tri_max, ctypes.c_float),
        t, max_leaf,
        ptr(node_min, ctypes.c_float), ptr(node_max, ctypes.c_float),
        ptr(node_a, ctypes.c_int32), ptr(node_count, ctypes.c_int32),
        ptr(prim_order, ctypes.c_int32))
    return (node_min[:n], node_max[:n], node_a[:n], node_count[:n], prim_order)
