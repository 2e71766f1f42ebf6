"""Cluster-scan ray trace: a linear scan over 512-triangle clusters, each
culled by its bounding box per block of rays.

Port of ``bifrost3d_tpu/geometry/pallas_clustered.py``
(``ClusteredTriangles``, ``pack_clustered``, ``clustered_intersect``). The
TPU kernel ``_clustered_kernel`` becomes the hand-written CUDA kernel
``csrc/clustered_intersect.cu``: one thread block per 256 rays keeps the
TPU kernel's block rule, and inside a fetched cluster each ray takes the
chunk-culled trace of ``csrc/dense_trace.cuh`` (its header says what
bounds it on an H100). It is the linear baseline the BVH kernels are
measured against and an accepted packing of ``RenderScene.tri_clustered``
(``scene._replace(tri_clustered=pack_clustered(scene.tri_verts,
scene.bvh))``), not the default one.

:func:`clustered_intersect` dispatches on the device of the rays: CUDA
tensors launch the kernel, CPU tensors take the plain PyTorch version
:func:`clustered_intersect_reference`, anything else raises. A failed build
or launch raises; nothing falls back. ``launch_count`` counts kernel
launches (plain-version calls do not count). Closest hit only: there is no
any-hit mode and no live prefix.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from bifrost3d_tpu_torch.geometry.bvh import BVH, build_soup_bvh
from bifrost3d_tpu_torch.geometry.pallas_intersect import (
    _check,
    _finish,
    _mt_block,
    culled_dense_intersect_reference,
    kernel_bound,
    record_tables,
)
from bifrost3d_tpu_torch.geometry.traverse import Hit, ray_bounds

BLOCK_R = 256      # rays per thread block: the granule of the box cull
CLUSTER_T = 512    # triangles per cluster
_BIG = 3.0e38
_THREADS = BLOCK_R

launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


class ClusteredTriangles(NamedTuple):
    """The cluster-scan packing, all on one device. The JAX package pads
    the box table to 128 lanes and 128-row multiples for its TPU tiling;
    here a box is one 32-byte record and there is one per cluster."""

    tri_components: torch.Tensor  # [16, T_pad] f32 BVH-ordered (v0, e1, e2)
                                  #   component-major, rows 9-15 zero
    cluster_boxes: torch.Tensor   # [C, 8] f32: lo.xyz, hi.xyz, 0, 0
    order: torch.Tensor           # [T_pad] int32 → original triangle ids
                                  #   (0 on padding slots)
    n_tris: int

    @staticmethod
    def from_numpy(arrays: dict, *, device) -> "ClusteredTriangles":
        """The packing from the JAX package's ``ClusteredTriangles`` fields
        held as numpy arrays: its 128-lane box rows are cut to one record
        per cluster, so both packages scan the same clusters."""
        comp = np.asarray(arrays["tri_components"], np.float32)
        n_clusters = comp.shape[1] // CLUSTER_T
        boxes = np.zeros((n_clusters, 8), np.float32)
        boxes[:, 0:6] = np.asarray(arrays["cluster_boxes"],
                                   np.float32)[:n_clusters, 0:6]
        return ClusteredTriangles(
            tri_components=torch.tensor(comp, device=device),
            cluster_boxes=torch.tensor(boxes, device=device),
            order=torch.tensor(np.asarray(arrays["order"], np.int32),
                               device=device),
            n_tris=int(arrays["n_tris"]))


def leaf_ordered_components(tri_verts, bvh: Optional[BVH], granule: int):
    """[t, 3, 3] triangles → (sorted triangles [t, 3, 3], components
    [16, T_pad], order [T_pad] int32, t) in the BVH's depth-first leaf order
    (``bvh.prim_indices``; the tree is built here when not given), the slot
    count padded with zeros to a multiple of ``granule``."""
    tv = torch.as_tensor(tri_verts, dtype=torch.float32)
    t = int(tv.shape[0])
    if bvh is None:
        bvh = build_soup_bvh(tv)
    order = bvh.prim_indices.to(device=tv.device, dtype=torch.int32)
    if order.shape[0] != t:
        raise ValueError(f"the BVH orders {order.shape[0]} triangles, the "
                         f"soup has {t}")
    sorted_tv = tv[order.long()]
    t_pad = ((t + granule - 1) // granule) * granule
    comp = torch.zeros((16, t_pad), dtype=torch.float32, device=tv.device)
    comp[0:3, :t] = sorted_tv[:, 0].T
    comp[3:6, :t] = (sorted_tv[:, 1] - sorted_tv[:, 0]).T
    comp[6:9, :t] = (sorted_tv[:, 2] - sorted_tv[:, 0]).T
    order_pad = torch.zeros(t_pad, dtype=torch.int32, device=tv.device)
    order_pad[:t] = order
    return sorted_tv, comp, order_pad, t


def pack_clustered(tri_verts, bvh: Optional[BVH] = None) -> ClusteredTriangles:
    """[t, 3, 3] world-space triangles → the cluster-scan packing, on the
    device of ``tri_verts`` (a numpy array packs on the CPU).

    Triangle order is the BVH's depth-first leaf order, so consecutive
    groups of ``CLUSTER_T`` slots are spatially tight; their bounding boxes
    are the culling structure."""
    sorted_tv, comp, order, t = leaf_ordered_components(tri_verts, bvh,
                                                        CLUSTER_T)
    device = comp.device
    n_clusters = comp.shape[1] // CLUSTER_T
    # Pad the last cluster with copies of the last triangle: they change no
    # minimum or maximum.
    pts = sorted_tv.reshape(-1, 3)
    pad = n_clusters * CLUSTER_T * 3 - pts.shape[0]
    if pad:
        pts = torch.cat([pts, pts[-1:].expand(pad, 3)])
    pts = pts.reshape(n_clusters, CLUSTER_T * 3, 3)
    boxes = torch.zeros((n_clusters, 8), dtype=torch.float32, device=device)
    if n_clusters:
        boxes[:, 0:3] = pts.amin(dim=1)
        boxes[:, 3:6] = pts.amax(dim=1)
    return ClusteredTriangles(tri_components=comp, cluster_boxes=boxes,
                              order=order, n_tris=t)


def slab_test(lo, hi, origin, inv_dir, t_lo, best_t):
    """The kernels' box rule for rays [r, 3] against one box (``lo``/``hi``
    [3]) or one box per ray ([r, 3]) → (hit [r], entry distance [r])."""
    t0 = (lo - origin) * inv_dir
    t1 = (hi - origin) * inv_dir
    near = torch.maximum(torch.amax(torch.minimum(t0, t1), dim=-1), t_lo)
    far = torch.amin(torch.maximum(t0, t1), dim=-1)
    return (near <= far) & (far > 0.0) & (near < best_t), near


def safe_inverse(direction):
    """sign(d) / max(|d|, 1e-12), the kernels' reciprocal direction."""
    sign = torch.where(direction < 0, -1.0, 1.0)
    return sign / torch.clamp_min(torch.abs(direction), 1e-12)


def cluster_test(comp, n_tris, clusters, rows, origin, direction, t_lo, t_hi,
                 best, freeze: bool = False):
    """Dense Möller–Trumbore of ray groups against one cluster each, merged
    into ``best`` = [t, slot, u, v] (tensors over all rays, updated in
    place). ``clusters`` int64 [n] and ``rows`` int64 [n, g]: the g rays
    ``rows[i]`` are tested against the 512 slots of ``clusters[i]``; no ray
    appears twice. The lowest slot wins inside a cluster, a strict '<'
    against the running best. With ``freeze`` (any-hit) a ray that hit gets
    best t = t_min, so it passes no further box."""
    if rows.numel() == 0:
        return
    best_t, best_slot, best_u, best_v = best
    tri = comp[:9].reshape(9, -1, CLUSTER_T)[:, clusters][:, :, None, :]
    o = tuple(origin[rows, c][..., None] for c in range(3))      # [n, g, 1]
    d = tuple(direction[rows, c][..., None] for c in range(3))
    # _mt_block puts one leading axis before the triangles' [n, 1, 512].
    t, u, v, valid = (x[0] for x in _mt_block(o, d, tri,
                                              t_lo[rows][..., None]))
    slot = (clusters[:, None, None] * CLUSTER_T
            + torch.arange(CLUSTER_T, device=comp.device))       # [n, 1, 512]
    valid = (valid & (slot < n_tris) & (t < t_hi[rows][..., None])
             & (t < best_t[rows][..., None]))
    t = torch.where(valid, t, _BIG)
    k = torch.argmin(t, dim=-1, keepdim=True)           # first minimum
    t_new = torch.gather(t, -1, k)[..., 0]
    closer = t_new < best_t[rows]
    hit_rows = rows[closer]
    best_t[hit_rows] = t_lo[hit_rows] if freeze else t_new[closer]
    best_slot[hit_rows] = torch.gather(
        slot.expand(t.shape), -1, k)[..., 0][closer].to(torch.int32)
    best_u[hit_rows] = torch.gather(u, -1, k)[..., 0][closer]
    best_v[hit_rows] = torch.gather(v, -1, k)[..., 0][closer]


def finish_slots(best, order) -> Hit:
    """[t, slot, u, v] → the Hit, slots mapped back through ``order``."""
    best_t, best_slot, best_u, best_v = best
    prim = torch.where(best_slot < 0, -1,
                       order[torch.clamp_min(best_slot, 0).long()])
    return _finish(best_t, prim, best_u, best_v)


def clustered_intersect_reference(packed: ClusteredTriangles, origin,
                                  direction, t_min, t_max,
                                  stats: Optional[dict] = None,
                                  culled: bool = False) -> Hit:
    """Plain PyTorch version of the kernel: the scan written step by step.
    For each cluster in slot order every ray is slab-tested against the
    cluster's box with its running best t; the blocks of ``BLOCK_R`` rays
    in which some ray passes fetch the cluster, and each of their rays takes
    its nearest hit among the cluster's triangles. Runs on any device.

    With ``culled`` a ray of a fetching block traces the cluster as the CUDA
    kernel does (:func:`culled_dense_intersect_reference` with its groups:
    the cluster's padded box, then its chunk boxes); the hits are the
    same. A ``stats`` dict, if given, receives ``fetches`` (block × cluster
    pairs that fetched) and ``clusters_read`` (distinct clusters fetched),
    with ``culled`` also ``cluster_tests`` (rays of fetching blocks tested
    against the padded box), ``box_tests`` (chunk boxes), ``tri_tests`` and
    ``chunks_read``."""
    r = origin.shape[0]
    device = origin.device
    t_lo = ray_bounds(t_min, r, origin)
    t_hi = ray_bounds(t_max, r, origin)
    inv_dir = safe_inverse(direction)
    best = (torch.clamp_max(t_hi, _BIG).clone(),
            torch.full((r,), -1, dtype=torch.int32, device=device),
            torch.zeros(r, dtype=torch.float32, device=device),
            torch.zeros(r, dtype=torch.float32, device=device))
    block = torch.arange(r, device=device) // BLOCK_R
    n_blocks = (r + BLOCK_R - 1) // BLOCK_R
    fetches = clusters_read = 0
    work = {}
    for c in range(packed.cluster_boxes.shape[0]):
        box = packed.cluster_boxes[c]
        hit, _ = slab_test(box[0:3], box[3:6], origin, inv_dir, t_lo, best[0])
        fetching = torch.zeros(n_blocks, dtype=torch.bool, device=device)
        fetching[block[hit]] = True
        n_fetching = int(fetching.sum())
        if n_fetching == 0:
            continue
        fetches += n_fetching
        clusters_read += 1
        rows = torch.nonzero(fetching[block])[:, 0]
        if culled:
            _culled_cluster(packed, c, rows, origin, direction, t_lo, best,
                            work)
        else:
            cluster_test(packed.tri_components, packed.n_tris,
                         torch.tensor([c], device=device), rows[None], origin,
                         direction, t_lo, t_hi, best)
    if stats is not None:
        stats.update(fetches=fetches, clusters_read=clusters_read)
        if culled:
            stats.update(cluster_tests=work.pop("group_tests", 0), **work)
    return finish_slots(best, packed.order)


def _culled_cluster(packed, c, rows, origin, direction, t_lo, best, work):
    """The rays ``rows`` of the fetching blocks trace cluster ``c`` by its
    padded box and chunk boxes, merged into ``best`` (in place) with a
    strict '<'; their work is added to ``work``."""
    base = c * CLUSTER_T
    n = min(CLUSTER_T, packed.n_tris - base)
    table = packed.tri_components[:, base:base + CLUSTER_T]
    best_t, best_slot, best_u, best_v = best
    hit = culled_dense_intersect_reference(
        table, n, origin[rows], direction[rows], t_lo[rows], best_t[rows],
        stats=work, groups=True)
    found = hit.prim >= 0
    hit_rows = rows[found]
    best_t[hit_rows] = hit.t[found]
    best_slot[hit_rows] = hit.prim[found] + base
    best_u[hit_rows] = hit.u[found]
    best_v[hit_rows] = hit.v[found]


@functools.lru_cache(maxsize=None)
def _library():
    from bifrost3d_tpu_torch.utils import cuda_build
    lib = cuda_build.load("clustered_intersect.cu")
    lib.clustered_intersect.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p]
    lib.clustered_intersect.restype = ctypes.c_int
    lib.clustered_intersect_boxes.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.clustered_intersect_boxes.restype = ctypes.c_int
    return lib


def clustered_intersect_cuda(packed: ClusteredTriangles, origin, direction,
                             t_min, t_max) -> Hit:
    """Launch ``csrc/clustered_intersect.cu`` on the current stream. The
    kernel reads ``origin`` and ``direction`` [r, 3] as they are, each
    bound as a number, a one-element tensor or an [r] tensor, and writes the
    final hits, prims through ``order``, into one allocation, whose views
    the returned Hit holds."""
    global launch_count
    device = origin.device
    r = int(origin.shape[0])
    if origin.shape != (r, 3) or direction.shape != (r, 3):
        raise ValueError("origin and direction must both be [r, 3]")
    if 4 * r >= 2**31:
        raise ValueError(f"{r} rays overflow the kernel's int32 indexing")
    comp, boxes = packed.tri_components, packed.cluster_boxes
    if comp.dim() != 2 or comp.shape[0] < 12 or comp.shape[1] % CLUSTER_T:
        raise ValueError("tri_components must be [>= 12, T_pad], T_pad a "
                         f"multiple of {CLUSTER_T}")
    n_clusters = comp.shape[1] // CLUSTER_T
    if boxes.shape != (n_clusters, 8):
        raise ValueError(f"cluster_boxes must be [{n_clusters}, 8]")
    if packed.order.shape != (comp.shape[1],):
        raise ValueError("order must hold one id per triangle slot")
    if not 0 <= packed.n_tris <= comp.shape[1]:
        raise ValueError(f"n_tris={packed.n_tris} exceeds the packed table")
    if -(-packed.n_tris // CLUSTER_T) != n_clusters:
        raise ValueError("every cluster of the packing must hold a triangle")
    origin, direction = origin.contiguous(), direction.contiguous()
    _check("origin", origin, torch.float32, device)
    _check("direction", direction, torch.float32, device)
    _check("tri_components", comp, torch.float32, device)
    _check("cluster_boxes", boxes, torch.float32, device)
    _check("order", packed.order, torch.int32, device)
    recs, chunk_boxes, padded = record_tables(
        comp, packed.n_tris, _library().clustered_intersect_boxes)
    # The bound tensors stay referenced until the launch is enqueued.
    lo, lo_ptr, lo_stride, _lo = kernel_bound(t_min, r, device, "t_min")
    hi, hi_ptr, hi_stride, _hi = kernel_bound(t_max, r, device, "t_max")

    out = torch.empty(4 * r, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _library().clustered_intersect(
        origin.data_ptr(), direction.data_ptr(), r, lo, lo_ptr, lo_stride,
        hi, hi_ptr, hi_stride, boxes.data_ptr(), n_clusters, recs.data_ptr(),
        chunk_boxes.data_ptr(), padded.data_ptr(), int(packed.n_tris),
        packed.order.data_ptr(), out.data_ptr(), _THREADS, stream)
    if err != 0:
        raise RuntimeError(f"clustered_intersect launch failed: cudaError "
                           f"{err}")
    launch_count += 1
    return Hit(t=out[:r], prim=out[r:2 * r].view(torch.int32),
               u=out[2 * r:3 * r], v=out[3 * r:4 * r])


def clustered_intersect(packed: ClusteredTriangles, origin, direction, t_min,
                        t_max) -> Hit:
    """Nearest hit of rays [r, 3] by the cluster scan; prim ids are
    original triangle indices.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    kind = origin.device.type
    if kind == "cuda":
        return clustered_intersect_cuda(packed, origin, direction, t_min,
                                        t_max)
    if kind == "cpu":
        return clustered_intersect_reference(packed, origin, direction,
                                             t_min, t_max)
    raise ValueError(f"no cluster-scan intersect for tensors on "
                     f"{origin.device}")
