"""Dense streaming ray × triangle nearest hit: the CUDA kernel's wrapper.

Port of ``bifrost3d_tpu/geometry/pallas_intersect.py`` (``pack_triangles``,
``pallas_intersect``, ``_mt_block``). The TPU kernel ``_intersect_kernel``
becomes the hand-written CUDA kernel ``csrc/dense_intersect.cu`` (one
thread per ray, triangle tiles in shared memory; its header says what
bounds it on an H100).

:func:`pallas_intersect` dispatches on the device of the tensors it is
given: CUDA tensors launch the kernel, CPU tensors take the plain PyTorch
version :func:`dense_intersect_reference`, anything else raises. A failed
build or launch raises; nothing falls back.

``launch_count`` counts kernel launches (plain-version calls do not count).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bifrost3d_tpu_torch.geometry.traverse import Hit, ray_bounds

BLOCK_T = 512       # triangle padding granule of the packed table
_EPS_DET = 1e-9
_BIG = 3.0e38
_CHUNK = 512        # triangles per step of the plain version

launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def pack_triangles(tri_verts):
    """[t, 3, 3] float32 vertex positions → ([16, T_pad] components, t).

    (v0, e1, e2) component-major in rows 0-8, rows 9-15 zero, columns
    padded to a multiple of ``BLOCK_T`` — the JAX package's layout.
    """
    tv = tri_verts.to(torch.float32)
    t = int(tv.shape[0])
    v0 = tv[:, 0]
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    t_pad = max(((t + BLOCK_T - 1) // BLOCK_T) * BLOCK_T, BLOCK_T)
    comp = torch.zeros((16, t_pad), dtype=torch.float32, device=tv.device)
    comp[:9, :t] = torch.cat([v0.T, e1.T, e2.T], dim=0)
    return comp, t


def _mt_block(o, d, tri, t_min):
    """Möller–Trumbore for [R, 1] rays × [1, T] triangles → [R, T], with
    the Pallas kernel's arithmetic. o/d: 3-tuples of [R, 1]; tri: [9, T]."""
    ox, oy, oz = o
    dx, dy, dz = d
    v0x, v0y, v0z = tri[0][None, :], tri[1][None, :], tri[2][None, :]
    e1x, e1y, e1z = tri[3][None, :], tri[4][None, :], tri[5][None, :]
    e2x, e2y, e2z = tri[6][None, :], tri[7][None, :], tri[8][None, :]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = (torch.where(torch.abs(det) > _EPS_DET, 1.0, 0.0)
               / torch.where(det == 0.0, 1.0, det))
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    valid = ((torch.abs(det) > _EPS_DET) & (u >= 0.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t > t_min))
    return t, u, v, valid


def _finish(t, prim, u, v) -> Hit:
    miss = prim < 0
    return Hit(t=torch.where(miss, float("inf"), t), prim=prim,
               u=torch.where(miss, 0.0, u), v=torch.where(miss, 0.0, v))


def dense_intersect_reference(tri_components, n_tris, origin, direction,
                              t_min, t_max, live_count=None) -> Hit:
    """Plain PyTorch version of the kernel: chunked brute force over the
    packed table with a running strict-'<' best, rays at index >=
    ``live_count`` reported as misses. Runs on any device."""
    r = origin.shape[0]
    t_lo = ray_bounds(t_min, r, origin)[:, None]
    t_hi = ray_bounds(t_max, r, origin)[:, None]
    o = tuple(origin[:, c:c + 1] for c in range(3))
    d = tuple(direction[:, c:c + 1] for c in range(3))
    best_t = torch.full((r,), _BIG, dtype=torch.float32, device=origin.device)
    best_prim = torch.full((r,), -1, dtype=torch.int32, device=origin.device)
    best_u = torch.zeros(r, dtype=torch.float32, device=origin.device)
    best_v = torch.zeros(r, dtype=torch.float32, device=origin.device)
    for start in range(0, n_tris, _CHUNK):
        stop = min(start + _CHUNK, n_tris)
        t, u, v, valid = _mt_block(o, d, tri_components[:9, start:stop], t_lo)
        valid = valid & (t < t_hi) & (t < best_t[:, None])
        t = torch.where(valid, t, _BIG)
        k = torch.argmin(t, dim=1, keepdim=True)      # first minimum
        t_new = torch.gather(t, 1, k)[:, 0]
        closer = t_new < best_t
        best_t = torch.where(closer, t_new, best_t)
        best_prim = torch.where(closer, (k[:, 0] + start).to(torch.int32),
                                best_prim)
        best_u = torch.where(closer, torch.gather(u, 1, k)[:, 0], best_u)
        best_v = torch.where(closer, torch.gather(v, 1, k)[:, 0], best_v)
    if live_count is not None:
        dead = torch.arange(r, device=origin.device) >= live_count
        best_t = torch.where(dead, _BIG, best_t)
        best_prim = torch.where(dead, -1, best_prim)
    return _finish(best_t, best_prim, best_u, best_v)


@functools.lru_cache(maxsize=None)
def _library():
    from bifrost3d_tpu_torch.utils import cuda_build
    lib = cuda_build.load("dense_intersect.cu")
    fn = lib.dense_intersect
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name, x, dtype, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def dense_intersect_cuda(tri_components, n_tris, origin, direction, t_min,
                         t_max, live_count=None) -> Hit:
    """Launch ``csrc/dense_intersect.cu`` on the current stream."""
    global launch_count
    device = origin.device
    r = int(origin.shape[0])
    if origin.shape != (r, 3) or direction.shape != (r, 3):
        raise ValueError("origin and direction must both be [r, 3]")
    if tri_components.dim() != 2 or tri_components.shape[0] < 9:
        raise ValueError("tri_components must be [>= 9, T_pad]")
    if not 0 <= n_tris <= tri_components.shape[1]:
        raise ValueError(f"n_tris={n_tris} exceeds the packed table")
    if 8 * r >= 2**31:
        raise ValueError(f"{r} rays overflow the kernel's int32 indexing")
    rays = torch.cat([origin.T, direction.T,
                      ray_bounds(t_min, r, origin)[None],
                      ray_bounds(t_max, r, origin)[None]], dim=0).contiguous()
    _check("rays", rays, torch.float32, device)
    _check("tri_components", tri_components, torch.float32, device)
    n_live = r if live_count is None else min(int(live_count), r)

    t = torch.empty(r, dtype=torch.float32, device=device)
    prim = torch.empty(r, dtype=torch.int32, device=device)
    u = torch.empty(r, dtype=torch.float32, device=device)
    v = torch.empty(r, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _library()(rays.data_ptr(), r, n_live, tri_components.data_ptr(),
                     int(tri_components.shape[1]), int(n_tris), t.data_ptr(),
                     prim.data_ptr(), u.data_ptr(), v.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"dense_intersect launch failed: cudaError {err}")
    launch_count += 1
    return _finish(t, prim, u, v)


def pallas_intersect(tri_components, n_tris, origin, direction, t_min, t_max,
                     live_count=None) -> Hit:
    """Nearest hit of rays [r, 3] against the packed triangle soup.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    kind = origin.device.type
    if kind == "cuda":
        return dense_intersect_cuda(tri_components, n_tris, origin, direction,
                                    t_min, t_max, live_count)
    if kind == "cpu":
        return dense_intersect_reference(tri_components, n_tris, origin,
                                         direction, t_min, t_max, live_count)
    raise ValueError(f"no dense intersect for tensors on {origin.device}")
