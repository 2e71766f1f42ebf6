"""Dense ray × triangle nearest hit: the CUDA kernel's wrapper.

Port of ``bifrost3d_tpu/geometry/pallas_intersect.py`` (``pack_triangles``,
``pallas_intersect``, ``_mt_block``). The TPU kernel ``_intersect_kernel``
becomes the hand-written CUDA kernel ``csrc/dense_intersect.cu``:
512-triangle tiles streamed through shared memory and the chunk-culled
Möller–Trumbore trace of ``csrc/dense_trace.cuh``, which the mesh
megakernel and the cluster scan share (the kernel's header says what
bounds it on an H100).

:func:`pallas_intersect` dispatches on the device of the tensors it is
given: CUDA tensors launch the kernel, CPU tensors take the plain PyTorch
version :func:`dense_intersect_reference` (the full scan), anything else
raises. A failed build or launch raises; nothing falls back.
:func:`culled_dense_intersect_reference` is the plain version of the
kernel's cull, with its work counts.

``launch_count`` counts kernel launches (plain-version calls do not count).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bifrost3d_tpu_torch.geometry.traverse import Hit, ray_bounds
from bifrost3d_tpu_torch.utils.versioned import VersionedCache

BLOCK_T = 512       # triangle padding granule of the packed table
_EPS_DET = 1e-9
_BIG = 3.0e38
_CHUNK = 512        # triangles per step of the plain version
# The kernels' cull (csrc/dense_trace.cuh kChunk, kChunkPad, kGroupChunks):
# chunks of consecutive triangles, each with a box padded by CHUNK_PAD of
# its largest coordinate and extent, and one box per GROUP_CHUNKS chunks.
CHUNK = 32
CHUNK_PAD = 1e-4
GROUP_CHUNKS = 16
_THREADS = 256      # the kernel's block size, one ray per thread

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


def triangle_rows(tri, n_tris: int):
    """The first ``n_tris`` triangles of a table as [n_tris, 9] rows (v0,
    e1, e2): the dense branch's [t_pad, 16] table (a triangle per row) or
    the packing's [16, T_pad] one (a triangle per column)."""
    if tri.shape[1] == 16:
        return tri[:n_tris, 0:9]
    return tri[0:9, :n_tris].T


def chunk_boxes(tri, n_tris: int):
    """The kernels' chunk boxes, as ``csrc/dense_trace.cuh`` builds them →
    (lo, hi) [n_chunks, 3]: the corners v0, v0 + e1, v0 + e2 of each run of
    ``CHUNK`` consecutive triangles of the table (either layout of
    :func:`triangle_rows`), padded by ``CHUNK_PAD`` × (largest |coordinate|
    + largest extent)."""
    rows = triangle_rows(tri, n_tris)
    v0 = rows[:, 0:3]
    corners = torch.stack([v0, v0 + rows[:, 3:6], v0 + rows[:, 6:9]])
    n_chunks = -(-n_tris // CHUNK)
    fill = corners.new_full((3, n_chunks * CHUNK - n_tris, 3), _BIG)
    lo = torch.cat([corners, fill], dim=1).amin(dim=0).reshape(
        n_chunks, CHUNK, 3).amin(dim=1)
    hi = torch.cat([corners, -fill], dim=1).amax(dim=0).reshape(
        n_chunks, CHUNK, 3).amax(dim=1)
    ext = (hi - lo).amax(dim=-1, keepdim=True)
    mag = torch.maximum(lo.abs(), hi.abs()).amax(dim=-1, keepdim=True)
    pad = CHUNK_PAD * (mag + ext)
    return lo - pad, hi + pad


def _enters(lo, hi, origin, inv, t_lo, t_lim):
    """The chunk rule: the ray meets the box in [t_min, t_far] before
    ``t_lim``."""
    t0, t1 = (lo - origin) * inv, (hi - origin) * inv
    t_near = torch.maximum(torch.minimum(t0, t1).amax(dim=-1), t_lo)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    return (t_near <= t_far) & (t_near < t_lim)


def culled_dense_intersect_reference(tri, n_tris: int, origin, direction,
                                     t_min, t_max, any_hit: bool = False,
                                     live=None, stats=None,
                                     live_count=None,
                                     groups: bool = False) -> Hit:
    """Plain version of the kernels' chunk-culled dense trace: the chunks of
    :func:`chunk_boxes` in index order, a chunk entered when the ray meets
    its box in [t_min, t_far] before the best hit so far (t_max with
    ``any_hit``, which stops at the first hit in index order), every
    triangle of an entered chunk tested. With ``groups`` a ray first tests
    the box of each ``GROUP_CHUNKS`` chunks (their union) and tests the
    chunk boxes of the groups it enters, as ``csrc/dense_intersect.cu``
    does. Rays at an index >= ``live_count`` trace nothing and miss. Hits
    equal :func:`dense_intersect_reference`'s. ``tri`` is either layout of
    :func:`triangle_rows`.

    ``stats``, if given, gains the work of the lanes in ``live`` (all lanes
    by default): ``box_tests`` (chunk boxes), ``tri_tests``, with
    ``groups`` ``group_tests``, and ``chunks_read`` (chunks entered by at
    least one such lane; their records are the distinct bytes read)."""
    r = origin.shape[0]
    device = origin.device
    rows = triangle_rows(tri, n_tris)
    lo, hi = chunk_boxes(tri, n_tris)
    n_chunks = lo.shape[0]
    inv = torch.where(direction < 0, -1.0, 1.0) / torch.clamp_min(
        direction.abs(), 1e-12)
    t_lo = ray_bounds(t_min, r, origin)
    best_t = torch.clamp_max(ray_bounds(t_max, r, origin), _BIG)
    best_prim = torch.full((r,), -1, dtype=torch.int32, device=device)
    best_u = torch.zeros(r, dtype=torch.float32, device=device)
    best_v = torch.zeros(r, dtype=torch.float32, device=device)
    counted = (torch.ones(r, dtype=torch.bool, device=device) if live is None
               else live)
    searching = torch.ones(r, dtype=torch.bool, device=device)
    if live_count is not None:
        searching = torch.arange(r, device=device) < live_count
        counted = counted & searching
    o = tuple(origin[:, c:c + 1] for c in range(3))
    d = tuple(direction[:, c:c + 1] for c in range(3))
    box_tests = tri_tests = group_tests = 0
    read = torch.zeros(n_chunks, dtype=torch.bool, device=device)
    in_group = searching
    for c in range(n_chunks):
        if groups and c % GROUP_CHUNKS == 0:
            g = slice(c, min(c + GROUP_CHUNKS, n_chunks))
            in_group = searching & _enters(lo[g].amin(dim=0), hi[g].amax(dim=0),
                                           origin, inv, t_lo, best_t)
            group_tests += int((searching & counted).sum())
        start, stop = c * CHUNK, min(n_tris, (c + 1) * CHUNK)
        enter = in_group & searching & _enters(lo[c], hi[c], origin, inv,
                                               t_lo, best_t)
        t, u, v, valid = _mt_block(o, d, rows[start:stop].T, t_lo[:, None])
        valid = valid & (t < best_t[:, None]) & enter[:, None]
        k = torch.argmin(torch.where(valid, t, _BIG), dim=1, keepdim=True)
        if any_hit:
            k = torch.argmax(valid.to(torch.int32), dim=1, keepdim=True)
        found = torch.gather(valid, 1, k)[:, 0]
        best_t = torch.where(found, torch.gather(t, 1, k)[:, 0], best_t)
        best_prim = torch.where(found, (k[:, 0] + start).to(torch.int32),
                                best_prim)
        best_u = torch.where(found, torch.gather(u, 1, k)[:, 0], best_u)
        best_v = torch.where(found, torch.gather(v, 1, k)[:, 0], best_v)
        if stats is not None:
            box_tests += int((in_group & searching & counted).sum())
            tests = torch.where(found, k[:, 0] + 1, stop - start) \
                if any_hit else stop - start
            tri_tests += int(torch.where(enter & counted, tests, 0).sum())
            read[c] = bool((enter & counted).any())
        if any_hit:
            searching = searching & ~found
    if stats is not None:
        for key, value in (("box_tests", box_tests), ("tri_tests", tri_tests),
                           ("chunks_read", int(read.sum()))):
            stats[key] = stats.get(key, 0) + value
        if groups:
            stats["group_tests"] = stats.get("group_tests", 0) + group_tests
    return _finish(best_t, best_prim, best_u, best_v)


@functools.lru_cache(maxsize=None)
def _library():
    from bifrost3d_tpu_torch.utils import cuda_build
    lib = cuda_build.load("dense_intersect.cu")
    lib.dense_intersect.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.dense_intersect.restype = ctypes.c_int
    lib.dense_intersect_boxes.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.dense_intersect_boxes.restype = ctypes.c_int
    return lib


def _check(name, x, dtype, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def kernel_bound(value, r: int, device, name: str):
    """A t bound as the trace kernels take it → (value, pointer, stride,
    the tensor to keep alive): a number by value; a one-element tensor
    through its pointer with stride 0 (no host sync); an [r] tensor with
    stride 1."""
    if not isinstance(value, torch.Tensor):
        return float(value), 0, 0, None
    if value.numel() == 1:
        stride = 0
    elif value.shape == (r,):
        stride = 1
    else:
        raise ValueError(f"{name} must be a number, one value or [r]")
    value = value.to(device=device, dtype=torch.float32).contiguous()
    return 0.0, value.data_ptr(), stride, value


def kernel_live(live_count, r: int, device):
    """The live count as the trace kernels take it → (value, pointer, bits,
    the tensor to keep alive): a number by value, clamped to [0, r]; a
    one-element int32 or int64 tensor through its pointer, which the kernel
    reads on the device (no host sync)."""
    if isinstance(live_count, torch.Tensor):
        if live_count.numel() != 1 or live_count.dtype not in (
                torch.int32, torch.int64):
            raise ValueError("a live_count tensor must be one int32 or int64")
        live_count = live_count.to(device)
        bits = 32 if live_count.dtype == torch.int32 else 64
        return r, live_count.data_ptr(), bits, live_count
    if live_count is None:
        return r, 0, 0, None
    return max(0, min(int(live_count), r)), 0, 0, None


def box_counts(n_tris: int):
    """→ (chunk boxes, group boxes) of an ``n_tris`` table."""
    n_chunks = -(-n_tris // CHUNK)
    return n_chunks, -(-n_chunks // GROUP_CHUNKS)


_TABLES = VersionedCache()


def record_tables(table, n_tris: int, build):
    """The trace kernels' tables for a packed table of triangles in slot
    order (the dense trace's and the cluster scan's [16, T_pad], the
    resident packing's [16, T_pad/128, 128]) → (records [n_tris, 12]: an
    AoS copy of rows 0-11, chunk boxes [n_chunks, 8], group boxes
    [n_groups, 8]: the union of each ``GROUP_CHUNKS`` padded chunk boxes),
    the boxes built on the card by ``build``, a library's export of
    csrc/dense_trace.cuh's build_boxes. Cached per (identity, version) of
    ``table`` itself: a view of it is a new object at every call."""
    key, tables = _TABLES.lookup((table,), n_tris)
    if tables is not None:
        return tables
    recs = table.reshape(table.shape[0], -1)[:12, :n_tris].T.contiguous()
    n_chunks, n_groups = box_counts(n_tris)
    boxes = torch.empty((max(n_chunks, 1), 8), dtype=torch.float32,
                        device=recs.device)
    groups = torch.empty((max(n_groups, 1), 8), dtype=torch.float32,
                         device=recs.device)
    stream = torch.cuda.current_stream(recs.device).cuda_stream
    err = build(recs.data_ptr(), n_tris, boxes.data_ptr(), groups.data_ptr(),
                stream)
    if err != 0:
        raise RuntimeError(f"chunk box build failed: cudaError {err}")
    return _TABLES.store(key, (table,), (recs, boxes, groups))


def dense_intersect_cuda(tri_components, n_tris, origin, direction, t_min,
                         t_max, live_count=None) -> Hit:
    """Launch ``csrc/dense_intersect.cu`` on the current stream. The kernel
    reads ``origin`` and ``direction`` [r, 3] as they are, each bound as a
    number, a one-element tensor or an [r] tensor, and a ``live_count``
    tensor (int32 or int64, one element) on the device, so a pool's live
    sum costs no host sync; it writes the final hits into one allocation,
    whose views the returned Hit holds."""
    global launch_count
    device = origin.device
    r = int(origin.shape[0])
    if origin.shape != (r, 3) or direction.shape != (r, 3):
        raise ValueError("origin and direction must both be [r, 3]")
    if tri_components.dim() != 2 or tri_components.shape[0] < 12:
        raise ValueError("tri_components must be [>= 12, T_pad]")
    if not 0 <= n_tris <= tri_components.shape[1]:
        raise ValueError(f"n_tris={n_tris} exceeds the packed table")
    if 4 * r >= 2**31:
        raise ValueError(f"{r} rays overflow the kernel's int32 indexing")
    origin, direction = origin.contiguous(), direction.contiguous()
    _check("origin", origin, torch.float32, device)
    _check("direction", direction, torch.float32, device)
    _check("tri_components", tri_components, torch.float32, device)
    recs, boxes, groups = record_tables(
        tri_components, int(n_tris), _library().dense_intersect_boxes)
    # The bound and count tensors stay referenced until the launch is
    # enqueued.
    lo, lo_ptr, lo_stride, _lo = kernel_bound(t_min, r, device, "t_min")
    hi, hi_ptr, hi_stride, _hi = kernel_bound(t_max, r, device, "t_max")
    n_live, live_ptr, live_bits, _live = kernel_live(live_count, r, device)

    out = torch.empty(4 * r, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _library().dense_intersect(
        origin.data_ptr(), direction.data_ptr(), r, lo, lo_ptr, lo_stride,
        hi, hi_ptr, hi_stride, n_live, live_ptr, live_bits, recs.data_ptr(),
        int(n_tris), boxes.data_ptr(), groups.data_ptr(), out.data_ptr(),
        _THREADS, stream)
    if err != 0:
        raise RuntimeError(f"dense_intersect launch failed: cudaError {err}")
    launch_count += 1
    return Hit(t=out[:r], prim=out[r:2 * r].view(torch.int32),
               u=out[2 * r:3 * r], v=out[3 * r:4 * r])


def pallas_intersect(tri_components, n_tris, origin, direction, t_min, t_max,
                     live_count=None) -> Hit:
    """Nearest hit of rays [r, 3] against the packed triangle soup. Rays at
    an index >= ``live_count`` (int or int tensor) report misses
    untraced.

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
