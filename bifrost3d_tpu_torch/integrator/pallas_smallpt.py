"""SmallPT megakernel: the whole path of every pixel in one kernel launch.

Port of ``bifrost3d_tpu/integrator/pallas_smallpt.py``
(``render_smallpt_megakernel``). The TPU kernel ``_make_kernel`` becomes
the hand-written CUDA kernel ``csrc/smallpt_megakernel.cu`` (persistent
lanes that regenerate paths, the sphere table in shared memory; its header
says what bounds it on an H100).

:func:`render_smallpt_megakernel` dispatches on the scene's device: a scene
on a CUDA card launches the kernel, a scene on the CPU takes the plain
PyTorch version :func:`smallpt_megakernel_reference` — the eager wavefront
of ``integrator/smallpt.py`` over all pixels, whose sample chain and
formulas the kernel follows. :func:`smallpt_megakernel_accumulate` lerps a
frame into a running mean in place, in the kernel on the card, so that a
progressive frame is one launch (and the memset of its pixel counter). The
kernel's sphere table and camera are cached on the card per (identity,
version) of the scene's tensors and the frame's size, so a repeated call
copies nothing to the card and waits for nothing. A failed build or launch
raises; nothing falls back. ``launch_count`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from bifrost3d_tpu_torch.integrator.smallpt import (
    camera_frame,
    render_smallpt_accumulation,
)
from bifrost3d_tpu_torch.scene.spheres import SphereScene
from bifrost3d_tpu_torch.utils.profiling import span
from bifrost3d_tpu_torch.utils.versioned import VersionedCache

MAX_SPHERES = 64     # the kernel's shared-memory table
_THREADS = 128       # the kernel's block size

launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def smallpt_megakernel_reference(scene: SphereScene, width: int, height: int,
                                 accumulation: int):
    """Plain PyTorch version of the kernel → radiance [height, width, 3],
    row 0 at the bottom. Runs on any device."""
    return render_smallpt_accumulation(scene, width, height, accumulation)


def smallpt_megakernel_accumulate_reference(scene: SphereScene, width: int,
                                            height: int, n: int, buffer):
    """Plain version of :func:`smallpt_megakernel_accumulate`: frame ``n``
    lerped into ``buffer`` in place with the app's torch line → buffer."""
    frame = smallpt_megakernel_reference(scene, width, height, n)
    return buffer.copy_(buffer + (frame - buffer) / n)


@functools.lru_cache(maxsize=None)
def _library():
    from bifrost3d_tpu_torch.utils import cuda_build
    lib = cuda_build.load("smallpt_megakernel.cu")
    lib.smallpt_megakernel.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.smallpt_megakernel.restype = ctypes.c_int
    lib.smallpt_blocks_per_sm.argtypes = [ctypes.c_int]
    lib.smallpt_blocks_per_sm.restype = ctypes.c_int
    lib.smallpt_rng_probe.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.smallpt_rng_probe.restype = ctypes.c_int
    return lib


def sphere_table(scene: SphereScene):
    """→ (float32 [n, 10]: centre, radius, emission, colour; int32 [n]
    BSDF ids), the kernel's scene."""
    sph = torch.cat([scene.position, scene.radius[:, None], scene.emission,
                     scene.color], dim=1).to(torch.float32).contiguous()
    return sph, scene.bsdf.to(torch.int32).contiguous()


_INPUT_CACHE = VersionedCache(16)


def kernel_inputs(scene: SphereScene, width: int, height: int) -> tuple:
    """The kernel's sphere table, BSDF ids and 12-float camera (origin,
    unit direction, cx, cy) on the scene's device, checked, and cached per
    (identity, version) of the scene's tensors and the frame's size: an
    in-place write to the scene is a miss."""
    sources = tuple(scene)
    key, cached = _INPUT_CACHE.lookup(sources, (int(width), int(height)))
    if cached is not None:
        return cached
    device = scene.position.device
    n = int(scene.position.shape[0])
    if not 0 < n <= MAX_SPHERES:
        raise ValueError(f"{n} spheres outside (0, {MAX_SPHERES}]")
    sph, bsdf = sphere_table(scene)
    if sph.shape != (n, 10) or bsdf.shape != (n,):
        raise ValueError("scene fields must be [n, 3], [n] and [n] int")
    cam = torch.cat(camera_frame(width, height, device)).contiguous()
    return _INPUT_CACHE.store(key, sources, (sph, bsdf, cam))


def blocks_per_sm() -> int:
    """Blocks of ``_THREADS`` that one SM of the card holds at once: the
    persistent grid's width per SM, from the CUDA runtime."""
    n = _library().smallpt_blocks_per_sm(_THREADS)
    if n < 0:
        raise RuntimeError(f"smallpt occupancy query failed: cudaError {-n}")
    return n


def _launch(scene: SphereScene, width: int, height: int, accumulation: int,
            inv_n: float, out, counter) -> None:
    """One launch writing (inv_n = 0) or lerping into ``out``. Under a
    ``torch.profiler`` session the call, from its checks to the launch's
    return, is span ``b3d.smallpt.launch``."""
    global launch_count
    with span("smallpt.launch"):
        if width <= 0 or height <= 0 or 3 * width * height >= 2**31:
            raise ValueError(f"{width}x{height} pixels outside the kernel's "
                             "int32 indexing")
        sph, bsdf, cam = kernel_inputs(scene, width, height)
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = _library().smallpt_megakernel(
            sph.data_ptr(), bsdf.data_ptr(), int(sph.shape[0]),
            cam.data_ptr(), width, height, int(accumulation) & 0xFFFFFFFF,
            inv_n, out.data_ptr(), counter.data_ptr(), _THREADS, stream)
    if err != 0:
        raise RuntimeError(f"smallpt_megakernel launch failed: cudaError {err}")
    launch_count += 1


def _require_cuda(scene: SphereScene):
    device = scene.position.device
    if device.type != "cuda":
        raise ValueError(f"the SmallPT kernel needs a scene on a CUDA card, "
                         f"not {device}")
    return device


def smallpt_megakernel_cuda(scene: SphereScene, width: int, height: int,
                            accumulation: int):
    """Launch ``csrc/smallpt_megakernel.cu`` on the current stream →
    radiance [height, width, 3], row 0 at the bottom (a view of one
    allocation whose last word is the kernel's pixel counter)."""
    device = _require_cuda(scene)
    out = torch.empty(3 * width * height + 1, dtype=torch.float32,
                      device=device)
    _launch(scene, width, height, accumulation, 0.0, out,
            out[-1:].view(torch.int32))
    return out[:-1].view(height, width, 3)


def smallpt_megakernel_accumulate(scene: SphereScene, width: int,
                                  height: int, n: int, buffer):
    """Frame ``n`` (accumulation n, n >= 1) lerped into the running mean
    ``buffer`` [height, width, 3] in place → buffer: ``buffer + (frame -
    buffer) / n``, bit for bit as torch computes it on the buffer's device
    (on the card in the kernel, one launch and one memset; on the CPU the
    plain version)."""
    n = int(n)
    if n < 1:
        raise ValueError(f"accumulation {n} must be >= 1")
    kind = scene.position.device.type
    if kind == "cpu":
        return smallpt_megakernel_accumulate_reference(scene, width, height,
                                                       n, buffer)
    device = _require_cuda(scene)
    if buffer.shape != (height, width, 3) or buffer.dtype != torch.float32 \
            or buffer.device != device or not buffer.is_contiguous():
        raise ValueError(f"buffer must be a contiguous float32 [{height}, "
                         f"{width}, 3] on {device}")
    counter = torch.empty(1, dtype=torch.int32, device=device)
    # torch divides by a host scalar on the card as a multiplication by the
    # scalar's float32 reciprocal.
    inv_n = float(np.float32(1.0) / np.float32(n))
    _launch(scene, width, height, n, inv_n, buffer, counter)
    return buffer


def rng_probe(x, y, width: int, accumulation: int, steps: int):
    """The kernel's pixel seed and LCG chain on the card for int64 pixel
    coords ``x``/``y`` [n] → (states int64 [steps, n] of uint32 values,
    floats float32 [steps, n]), for holding them bit for bit against
    ``jenkins_hash``/``lcg_next``."""
    device = x.device
    n = int(x.shape[0])
    xs = x.to(torch.int32).contiguous()
    ys = y.to(torch.int32).contiguous()
    states = torch.empty((steps, n), dtype=torch.int32, device=device)
    floats = torch.empty((steps, n), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _library().smallpt_rng_probe(
        xs.data_ptr(), ys.data_ptr(), n, width,
        int(accumulation) & 0xFFFFFFFF, steps, states.data_ptr(),
        floats.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"smallpt_rng_probe launch failed: cudaError {err}")
    return states.to(torch.int64) & 0xFFFFFFFF, floats


def render_smallpt_megakernel(scene: SphereScene, width: int, height: int,
                              accumulation: int):
    """One progressive SmallPT frame, whole paths in one kernel launch →
    radiance [height, width, 3] (the sample chains of
    ``render_smallpt_accumulation``)."""
    kind = scene.position.device.type
    if kind == "cuda":
        return smallpt_megakernel_cuda(scene, width, height, accumulation)
    if kind == "cpu":
        return smallpt_megakernel_reference(scene, width, height, accumulation)
    raise ValueError(f"no SmallPT megakernel for a scene on "
                     f"{scene.position.device}")
