"""SmallPT megakernel: the whole path of every pixel in one kernel launch.

Port of ``bifrost3d_tpu/integrator/pallas_smallpt.py``
(``render_smallpt_megakernel``). The TPU kernel ``_make_kernel`` becomes
the hand-written CUDA kernel ``csrc/smallpt_megakernel.cu`` (one thread
per pixel, the sphere table in shared memory; its header says what bounds
it on an H100).

:func:`render_smallpt_megakernel` dispatches on the scene's device: a scene
on a CUDA card launches the kernel, a scene on the CPU takes the plain
PyTorch version :func:`smallpt_megakernel_reference` — the eager wavefront
of ``integrator/smallpt.py`` over all pixels, whose sample chain and
formulas the kernel follows. A failed build or launch raises; nothing falls
back. ``launch_count`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bifrost3d_tpu_torch.integrator.smallpt import (
    camera_frame,
    render_smallpt_accumulation,
)
from bifrost3d_tpu_torch.scene.spheres import SphereScene

MAX_SPHERES = 64     # the kernel's shared-memory table
_THREADS = 128       # the kernel's block size, one pixel per thread

launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def smallpt_megakernel_reference(scene: SphereScene, width: int, height: int,
                                 accumulation: int):
    """Plain PyTorch version of the kernel → radiance [height, width, 3],
    row 0 at the bottom. Runs on any device."""
    return render_smallpt_accumulation(scene, width, height, accumulation)


@functools.lru_cache(maxsize=None)
def _library():
    from bifrost3d_tpu_torch.utils import cuda_build
    lib = cuda_build.load("smallpt_megakernel.cu")
    lib.smallpt_megakernel.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p]
    lib.smallpt_megakernel.restype = ctypes.c_int
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


def smallpt_megakernel_cuda(scene: SphereScene, width: int, height: int,
                            accumulation: int):
    """Launch ``csrc/smallpt_megakernel.cu`` on the current stream →
    radiance [height, width, 3], row 0 at the bottom."""
    global launch_count
    device = scene.position.device
    if device.type != "cuda":
        raise ValueError(f"the SmallPT kernel needs a scene on a CUDA card, "
                         f"not {device}")
    n = int(scene.position.shape[0])
    if not 0 < n <= MAX_SPHERES:
        raise ValueError(f"{n} spheres outside (0, {MAX_SPHERES}]")
    if width <= 0 or height <= 0 or 3 * width * height >= 2**31:
        raise ValueError(f"{width}x{height} pixels outside the kernel's "
                         "int32 indexing")
    sph, bsdf = sphere_table(scene)
    if sph.shape != (n, 10) or bsdf.shape != (n,):
        raise ValueError("scene fields must be [n, 3], [n] and [n] int")
    cam = torch.cat(camera_frame(width, height, device)).contiguous()
    out = torch.empty((height, width, 3), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _library().smallpt_megakernel(
        sph.data_ptr(), bsdf.data_ptr(), n, cam.data_ptr(), width, height,
        int(accumulation) & 0xFFFFFFFF, out.data_ptr(), _THREADS, stream)
    if err != 0:
        raise RuntimeError(f"smallpt_megakernel launch failed: cudaError {err}")
    launch_count += 1
    return out


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
