"""Build a CUDA source of ``csrc/`` into a shared library and load it.

The kernels have a plain C interface and are loaded with ``ctypes``:
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`` builds one in seconds, where a PyTorch C++ extension takes minutes.
The library goes to ``build/kernels/`` at the repository root, named by a
hash of its source and of the ``csrc/`` headers it includes, and is built
at first use. A missing ``nvcc`` or a
failed build raises; nothing falls back to a plain version. ``builds``
counts the nvcc runs of the process and ``loads`` the libraries loaded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "kernels")

CUDA_HOME_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

builds = 0
loads = 0


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists(CUDA_HOME_NVCC):
        nvcc = CUDA_HOME_NVCC
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "csrc/ at first use and need the CUDA toolkit")
    return nvcc


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_text(source: str, _seen=None) -> bytes:
    """The text of ``csrc/<source>`` followed by that of every ``csrc/``
    header it includes with quotes, transitively, each once."""
    seen = set() if _seen is None else _seen
    seen.add(source)
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        text = f.read()
    for name in _LOCAL_INCLUDE.findall(text):
        name = name.decode()
        if name not in seen:
            text += source_text(name, seen)
    return text


def library_path(source: str) -> str:
    """Where ``csrc/<source>`` builds to: keyed by a hash of its text, its
    local headers' text and the compiler flags, so an edit to a shared
    header never loads a stale library."""
    digest = hashlib.sha256(source_text(source) + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def build(source: str) -> str:
    """Compile ``csrc/<source>`` unless its library exists → the .so path.
    The compiler's register report is kept beside it as ``.log``."""
    global builds
    out = library_path(source)
    if os.path.exists(out):
        return out
    nvcc = find_nvcc()
    builds += 1
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) for {source}:\n"
                               f"{proc.stdout}{proc.stderr}")
        with open(os.path.splitext(out)[0] + ".log", "w") as log:
            log.write(proc.stdout + proc.stderr)
        os.replace(tmp, out)   # atomic: concurrent builders both succeed
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """Build if needed and load ``csrc/<source>`` (once per process)."""
    global loads
    lib = ctypes.CDLL(build(source))
    loads += 1
    return lib
