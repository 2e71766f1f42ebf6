"""Resident-cluster BVH ray trace: groups of 32 rays walk a BVH over
512-triangle clusters with one shared stack, the triangle table read in
place.

Port of ``bifrost3d_tpu/geometry/pallas_bvh_vmem.py`` (``VmemTriangles``,
``fits_vmem``, ``pack_vmem``, ``vmem_intersect``). The TPU kernel
``_make_vmem_kernel`` becomes the hand-written CUDA kernel
``csrc/vmem_intersect.cu``: the TPU's group walk kept (one warp per 32-ray
group, the group's stack in shared memory), and at an entered leaf each
ray culls by the cluster's padded box and its 16 chunk boxes through
``csrc/dense_trace.cuh``, the trace the dense kernel, the cluster scan and
the mesh megakernel share (its header says what bounds it on an H100). On
the TPU the whole table sits in VMEM, and ``fits_vmem`` caps it at 12 MiB.
An H100 has no fast memory of that size under program control: a block has
227 KB of shared memory. The cap is kept as the packing's contract, and on
the card it bounds the table to what the 50 MB L2 holds beside the rays.
The kernel does not pin the table there (no access-policy window): whether
that helps is not measured.

The packing is an accepted one of ``RenderScene.tri_clustered``
(``scene._replace(tri_clustered=pack_vmem(scene.tri_verts, scene.bvh))``),
not the default.

:func:`vmem_intersect` dispatches on the device of the rays: CUDA tensors
launch the kernel, CPU tensors take the plain PyTorch version
:func:`vmem_intersect_reference` (its ``culled`` form is the plain model of
the kernel's leaf test), anything else raises. A failed build or launch
raises; nothing falls back. ``launch_count`` counts kernel launches
(plain-version calls do not count).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from bifrost3d_tpu_torch.geometry.bvh import BVH, STACK_SIZE, build_bvh_boxes
from bifrost3d_tpu_torch.geometry.pallas_clustered import (
    CLUSTER_T,
    cluster_test,
    finish_slots,
    leaf_ordered_components,
    safe_inverse,
    slab_test,
)
from bifrost3d_tpu_torch.geometry.pallas_intersect import (
    CHUNK,
    GROUP_CHUNKS,
    _check,
    _enters,
    _mt_block,
    chunk_boxes,
    kernel_bound,
    kernel_live,
    record_tables,
    triangle_rows,
)
from bifrost3d_tpu_torch.geometry.traverse import Hit, ray_bounds

BLOCK_R = 128      # rays per thread block
GROUP_R = 32       # rays per walk: a warp
_BIG = 3.0e38
_THREADS = BLOCK_R
_LEAF_CHUNK = 512  # groups per step of the plain version's leaf test

# The resident triangle table's budget: the TPU kernel's VMEM share, kept
# as the packing's contract (on the card: well inside the 50 MB L2).
VMEM_TRI_BYTES = 12 * 1024 * 1024

launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


class VmemTriangles(NamedTuple):
    """The resident-cluster packing, all on one device. The JAX package
    pads node boxes to 128 lanes for its TPU tiling; here a box is one
    32-byte record."""

    tri_planes: torch.Tensor   # [16, T_pad/128, 128] f32 component-planar
                               #   (v0, e1, e2) in BVH leaf order
    node_boxes: torch.Tensor   # [n, 8] f32: lo.xyz, hi.xyz, 0, 0
    node_meta: torch.Tensor    # [n] int32: internal → right child (left is
                               #   node + 1); leaf → -(cluster + 1)
    order: torch.Tensor        # [T_pad] int32 → original triangle ids
    n_tris: int
    max_depth: int             # of the cluster tree; the stack holds
                               #   STACK_SIZE entries

    @staticmethod
    def from_numpy(arrays: dict, *, device) -> "VmemTriangles":
        """The packing from the JAX package's ``VmemTriangles`` fields held
        as numpy arrays: its 128-lane, row-padded node table is cut to one
        record per node of the cluster tree, so both packages walk the same
        tree. The tree's depth is measured here."""
        planes = np.asarray(arrays["tri_planes"], np.float32)
        n_nodes = 2 * (planes.shape[1] * 128 // CLUSTER_T) - 1
        meta = np.asarray(arrays["node_meta"], np.int32)[:n_nodes]
        boxes = np.zeros((n_nodes, 8), np.float32)
        boxes[:, 0:6] = np.asarray(arrays["node_boxes"],
                                   np.float32)[:n_nodes, 0:6]
        depth, stack = 1, [(0, 1)]
        while stack:
            node, d = stack.pop()
            depth = max(depth, d)
            if meta[node] >= 0:
                stack += [(node + 1, d + 1), (int(meta[node]), d + 1)]
        return VmemTriangles(
            tri_planes=torch.tensor(planes, device=device),
            node_boxes=torch.tensor(boxes, device=device),
            node_meta=torch.tensor(meta, device=device),
            order=torch.tensor(np.asarray(arrays["order"], np.int32),
                               device=device),
            n_tris=int(arrays["n_tris"]), max_depth=depth)


def fits_vmem(n_tris: int) -> bool:
    """Whether a soup of ``n_tris`` triangles packs within the resident
    table's budget (64 bytes per padded slot)."""
    t_pad = ((n_tris + CLUSTER_T - 1) // CLUSTER_T) * CLUSTER_T
    return t_pad * 16 * 4 <= VMEM_TRI_BYTES


def pack_vmem(tri_verts, bvh: Optional[BVH] = None) -> VmemTriangles:
    """[t, 3, 3] world-space triangles → the resident-cluster packing, on
    the device of ``tri_verts`` (a numpy array packs on the CPU): BVH leaf
    order, ``CLUSTER_T``-sized leaves, a BVH over the clusters' boxes on
    top. The cluster tree's depth is checked against the walk's stack."""
    sorted_tv, comp, order, t = leaf_ordered_components(tri_verts, bvh,
                                                        CLUSTER_T)
    device = comp.device
    t_pad = comp.shape[1]
    n_clusters = t_pad // CLUSTER_T
    if n_clusters == 0:
        raise ValueError("cannot pack an empty soup")
    # Edge padding: the last cluster's box covers its real triangles only.
    pts = sorted_tv.reshape(-1, 3)
    pad = t_pad * 3 - pts.shape[0]
    if pad:
        pts = torch.cat([pts, pts[-1:].expand(pad, 3)])
    pts = pts.reshape(n_clusters, CLUSTER_T * 3, 3)
    cbvh = build_bvh_boxes(pts.amin(dim=1).cpu().numpy(),
                           pts.amax(dim=1).cpu().numpy(), max_leaf=1)
    depth = cbvh.max_depth
    if depth + 1 > STACK_SIZE:
        raise ValueError(f"cluster BVH depth {depth} exceeds the kernel "
                         f"stack ({STACK_SIZE})")
    n_nodes = cbvh.node_count_total
    boxes = torch.zeros((n_nodes, 8), dtype=torch.float32)
    boxes[:, 0:3] = cbvh.node_min
    boxes[:, 3:6] = cbvh.node_max
    is_leaf = cbvh.node_count > 0
    leaf_cluster = cbvh.prim_indices[(cbvh.node_a * is_leaf).long()]
    meta = torch.where(is_leaf, -(leaf_cluster + 1), cbvh.node_a)
    return VmemTriangles(
        tri_planes=comp.reshape(16, t_pad // 128, 128),
        node_boxes=boxes.to(device), node_meta=meta.to(torch.int32).to(device),
        order=order, n_tris=t, max_depth=depth)


def vmem_intersect_reference(packed: VmemTriangles, origin, direction, t_min,
                             t_max, any_hit: bool = False, live_count=None,
                             stats: Optional[dict] = None,
                             culled: bool = False) -> Hit:
    """Plain PyTorch version of the kernel: the group walk written out, all
    groups advancing one node per step of a Python loop. Each group of
    ``GROUP_R`` consecutive rays has one stack; a step pops one node per
    active group; a leaf whose box some ray of the group passes tests all
    the group's rays against its cluster; an internal node probes both
    children and pushes those some ray passes, the one with the smaller
    nearest entry over the group last (popped first). With ``any_hit`` a
    ray that hit is frozen (best t = t_min) and a group stops when all its
    rays are done. Groups starting at an index >= ``live_count`` report
    misses. Runs on any device.

    With ``culled`` the rays of a group that enters a leaf trace it as the
    CUDA kernel does (:func:`_culled_leaves`: the cluster's padded box, its
    chunk boxes, the triangles of the chunks entered); the hits are the
    same bit for bit.

    A ``stats`` dict, if given, receives ``steps``, ``probes`` (group ×
    node box tests), ``leaf_tests`` (group × cluster tests),
    ``nodes_read`` and ``clusters_read`` (distinct ones); with ``culled``
    also ``cluster_tests`` (rays of entering groups tested against the
    padded cluster box), ``box_tests`` (chunk boxes), ``tri_tests`` and
    ``chunks_read`` (distinct chunks entered)."""
    r = origin.shape[0]
    device = origin.device
    n_groups = (r + GROUP_R - 1) // GROUP_R
    pad = n_groups * GROUP_R - r
    t_lo = ray_bounds(t_min, r, origin)
    t_hi = ray_bounds(t_max, r, origin)
    if pad:
        # Rays past the last one pass no box: best t = t_min = 0.
        origin = torch.cat([origin, origin.new_zeros((pad, 3))])
        direction = torch.cat([direction, direction.new_zeros((pad, 3))])
        t_lo = torch.cat([t_lo, t_lo.new_zeros(pad)])
        t_hi = torch.cat([t_hi, t_hi.new_zeros(pad)])
    in_range = torch.arange(n_groups * GROUP_R, device=device) < r
    inv_dir = safe_inverse(direction)
    best = (torch.clamp_max(t_hi, _BIG).clone(),
            torch.full((n_groups * GROUP_R,), -1, dtype=torch.int32,
                       device=device),
            torch.zeros(n_groups * GROUP_R, dtype=torch.float32,
                        device=device),
            torch.zeros(n_groups * GROUP_R, dtype=torch.float32,
                        device=device))
    comp = packed.tri_planes.reshape(16, -1)
    lo, hi = packed.node_boxes[:, 0:3], packed.node_boxes[:, 3:6]
    meta = packed.node_meta.to(torch.int64)
    lanes = torch.arange(GROUP_R, device=device)
    rays = (origin, direction, inv_dir, t_lo, in_range)
    if culled:
        tables = _cull_tables(comp, packed.n_tris)
        work = dict(cluster_tests=0, box_tests=0, tri_tests=0,
                    chunks=torch.zeros(-(-packed.n_tris // CHUNK),
                                       dtype=torch.bool, device=device))

    def probe(groups, nodes):
        """→ (some ray of the group passes [n], nearest entry [n])."""
        rows = (groups[:, None] * GROUP_R + lanes).reshape(-1)
        hit, near = slab_test(
            lo[nodes].repeat_interleave(GROUP_R, dim=0),
            hi[nodes].repeat_interleave(GROUP_R, dim=0), origin[rows],
            inv_dir[rows], t_lo[rows], best[0][rows])
        hit = hit.reshape(-1, GROUP_R)
        near = torch.where(hit, near.reshape(-1, GROUP_R), _BIG)
        return hit.any(dim=1), near.amin(dim=1)

    stack = torch.zeros((n_groups, STACK_SIZE + 2), dtype=torch.int64,
                        device=device)
    sp = torch.ones(n_groups, dtype=torch.int64, device=device)
    if live_count is not None:
        starts = torch.arange(n_groups, device=device) * GROUP_R
        sp = torch.where(starts < live_count, sp, 0)
    steps = probes = leaf_tests = 0
    node_seen = torch.zeros(meta.shape[0], dtype=torch.bool, device=device)
    cluster_seen = torch.zeros(comp.shape[1] // CLUSTER_T, dtype=torch.bool,
                               device=device)
    while True:
        groups = torch.nonzero(sp > 0)[:, 0]
        if groups.numel() == 0:
            break
        steps += 1
        sp[groups] -= 1
        node = stack[groups, sp[groups]]
        m = meta[node]
        is_leaf = m < 0
        node_seen[node] = True

        leaf_groups, leaf_nodes = groups[is_leaf], node[is_leaf]
        if leaf_groups.numel():
            probes += leaf_groups.numel()
            entered, _ = probe(leaf_groups, leaf_nodes)
            leaf_groups = leaf_groups[entered]
            clusters = (-m[is_leaf] - 1)[entered]
            leaf_tests += leaf_groups.numel()
            cluster_seen[clusters] = True
            for s in range(0, leaf_groups.numel(), _LEAF_CHUNK):
                part = slice(s, s + _LEAF_CHUNK)
                rows = leaf_groups[part, None] * GROUP_R + lanes
                if culled:
                    _culled_leaves(tables, clusters[part], rows, rays, best,
                                   work, any_hit)
                else:
                    cluster_test(comp, packed.n_tris, clusters[part], rows,
                                 origin, direction, t_lo, t_hi, best,
                                 freeze=any_hit)

        inner_groups, inner_nodes = groups[~is_leaf], node[~is_leaf]
        if inner_groups.numel():
            probes += 2 * inner_groups.numel()
            left, right = inner_nodes + 1, m[~is_leaf]
            node_seen[left] = True
            node_seen[right] = True
            any_l, near_l = probe(inner_groups, left)
            any_r, near_r = probe(inner_groups, right)
            swap = near_l > near_r
            first = torch.where(swap, right, left)
            second = torch.where(swap, left, right)
            push_first = torch.where(swap, any_r, any_l)
            push_second = torch.where(swap, any_l, any_r)
            # As the kernel: write the slot, advance only on a push.
            top = sp[inner_groups]
            stack[inner_groups, top] = second
            top = top + push_second.to(torch.int64)
            stack[inner_groups, top] = first
            sp[inner_groups] = top + push_first.to(torch.int64)

        if any_hit:
            done = ((best[1] >= 0) | ~in_range).reshape(-1, GROUP_R).all(dim=1)
            sp = torch.where(done, 0, sp)

    if stats is not None:
        stats.update(steps=steps, probes=probes, leaf_tests=leaf_tests,
                     nodes_read=int(node_seen.sum()),
                     clusters_read=int(cluster_seen.sum()))
        if culled:
            chunks = work.pop("chunks")
            stats.update(chunks_read=int(chunks.sum()), **work)
    return finish_slots(tuple(x[:r] for x in best), packed.order)


def _cull_tables(comp, n_tris: int):
    """The kernel's cull tables of a packing's [16, T_pad] table →
    (triangle rows [n_tris, 9], chunk boxes (lo, hi) [n_chunks, 3], padded
    cluster boxes (lo, hi) [n_clusters, 3]: the union of each cluster's
    ``GROUP_CHUNKS`` chunk boxes, as csrc/dense_trace.cuh builds them)."""
    lo, hi = chunk_boxes(comp, n_tris)
    n_clusters = -(-n_tris // CLUSTER_T)
    fill = lo.new_full((n_clusters * GROUP_CHUNKS - lo.shape[0], 3), _BIG)
    cluster_lo = torch.cat([lo, fill]).reshape(n_clusters, GROUP_CHUNKS,
                                               3).amin(dim=1)
    cluster_hi = torch.cat([hi, -fill]).reshape(n_clusters, GROUP_CHUNKS,
                                                3).amax(dim=1)
    return triangle_rows(comp, n_tris), (lo, hi), (cluster_lo, cluster_hi)


def _culled_leaves(tables, clusters, rows, rays, best, work, any_hit: bool):
    """The plain model of the kernel's leaf test: the rays ``rows`` [n, g]
    of groups that entered the leaves ``clusters`` [n] (no ray twice), each
    ray past the last one skipped, trace them one chunk position at a time,
    merged into ``best`` = [t, slot, u, v] (in place): a ray skips the leaf
    when it misses the cluster's padded box or enters it no nearer than its
    best hit, then tests the chunks whose boxes it enters before its best
    hit so far, in slot order, every triangle of an entered chunk with a
    strict '<' (:func:`culled_dense_intersect_reference`'s rule, ray by ray
    on its own cluster). With ``any_hit`` a ray that hit the leaf is then
    frozen (best t = t_min), as :func:`cluster_test` freezes it. The work
    is added to ``work``."""
    tri, (lo, hi), (cluster_lo, cluster_hi) = tables
    origin, direction, inv_dir, t_lo, in_range = rays
    best_t, best_slot, best_u, best_v = best
    n_tris, n_chunks = tri.shape[0], lo.shape[0]
    cluster = clusters.repeat_interleave(rows.shape[1])
    rows = rows.reshape(-1)
    live = in_range[rows]
    rows, cluster = rows[live], cluster[live]
    work["cluster_tests"] += rows.numel()
    enters = _enters(cluster_lo[cluster], cluster_hi[cluster], origin[rows],
                     inv_dir[rows], t_lo[rows], best_t[rows])
    rows, cluster = rows[enters], cluster[enters]
    o, inv, t_min = origin[rows], inv_dir[rows], t_lo[rows]
    o_cols = tuple(o[:, c:c + 1] for c in range(3))
    d_cols = tuple(direction[rows, c:c + 1] for c in range(3))
    t, slot = best_t[rows], best_slot[rows]
    u, v = best_u[rows], best_v[rows]
    lane = torch.arange(CHUNK, device=rows.device)
    for j in range(GROUP_CHUNKS):
        chunk = cluster * GROUP_CHUNKS + j
        tested = chunk < n_chunks
        chunk = torch.clamp_max(chunk, n_chunks - 1)
        work["box_tests"] += int(tested.sum())
        enter = tested & _enters(lo[chunk], hi[chunk], o, inv, t_min, t)
        slots = chunk[:, None] * CHUNK + lane                      # [m, 32]
        tris = tri[torch.clamp_max(slots, n_tris - 1)].permute(2, 0, 1)
        # _mt_block puts one leading axis before the triangles' [m, 32].
        tt, tu, tv, valid = (x[0] for x in _mt_block(o_cols, d_cols, tris,
                                                     t_min[:, None]))
        valid = valid & (slots < n_tris) & enter[:, None] & (tt < t[:, None])
        k = torch.argmin(torch.where(valid, tt, _BIG), dim=1, keepdim=True)
        found = torch.gather(valid, 1, k)[:, 0]
        t = torch.where(found, torch.gather(tt, 1, k)[:, 0], t)
        slot = torch.where(found, torch.gather(slots, 1, k)[:, 0].to(
            torch.int32), slot)
        u = torch.where(found, torch.gather(tu, 1, k)[:, 0], u)
        v = torch.where(found, torch.gather(tv, 1, k)[:, 0], v)
        in_chunk = torch.clamp(n_tris - chunk * CHUNK, max=CHUNK)
        work["tri_tests"] += int(torch.where(enter, in_chunk, 0).sum())
        work["chunks"][chunk[enter]] = True
    best_t[rows] = torch.where(slot >= 0, t_min, t) if any_hit else t
    best_slot[rows] = slot
    best_u[rows] = u
    best_v[rows] = v


@functools.lru_cache(maxsize=None)
def _library():
    from bifrost3d_tpu_torch.utils import cuda_build
    lib = cuda_build.load("vmem_intersect.cu")
    lib.vmem_intersect.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.vmem_intersect.restype = ctypes.c_int
    lib.vmem_intersect_boxes.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.vmem_intersect_boxes.restype = ctypes.c_int
    return lib


def vmem_intersect_cuda(packed: VmemTriangles, origin, direction, t_min,
                        t_max, any_hit: bool = False, live_count=None) -> Hit:
    """Launch ``csrc/vmem_intersect.cu`` on the current stream. The kernel
    reads ``origin`` and ``direction`` [r, 3] as they are, each bound as a
    number, a one-element tensor or an [r] tensor, and a ``live_count``
    tensor (int32 or int64, one element) on the device, so a pool's live
    sum costs no host sync; it writes the final hits, prims through
    ``order``, into one allocation, whose views the returned Hit holds.
    The records and boxes are built at a packing's first call and cached
    per (identity, version) of its ``tri_planes``."""
    global launch_count
    device = origin.device
    r = int(origin.shape[0])
    if origin.shape != (r, 3) or direction.shape != (r, 3):
        raise ValueError("origin and direction must both be [r, 3]")
    if 4 * r >= 2**31:
        raise ValueError(f"{r} rays overflow the kernel's int32 indexing")
    planes, boxes, meta = packed.tri_planes, packed.node_boxes, packed.node_meta
    if planes.dim() != 3 or planes.shape[0] < 12 or planes.shape[2] != 128 \
            or (planes.shape[1] * 128) % CLUSTER_T:
        raise ValueError("tri_planes must be [>= 12, T_pad/128, 128], T_pad "
                         f"a multiple of {CLUSTER_T}")
    t_pad = int(planes.shape[1]) * 128
    if boxes.dim() != 2 or boxes.shape[1] != 8 or boxes.shape[0] < 1 \
            or meta.shape != (boxes.shape[0],):
        raise ValueError("node_boxes must be [n >= 1, 8] and node_meta [n]")
    if packed.order.shape != (t_pad,):
        raise ValueError("order must hold one id per triangle slot")
    if not 0 <= packed.n_tris <= t_pad:
        raise ValueError(f"n_tris={packed.n_tris} exceeds the packed table")
    if -(-packed.n_tris // CLUSTER_T) != t_pad // CLUSTER_T:
        raise ValueError("every cluster of the packing must hold a triangle")
    if not fits_vmem(packed.n_tris):
        raise ValueError(f"{packed.n_tris} triangles exceed the resident "
                         f"table's {VMEM_TRI_BYTES} bytes")
    if packed.max_depth + 1 > STACK_SIZE:
        raise ValueError(f"cluster BVH depth {packed.max_depth} exceeds the "
                         f"kernel stack ({STACK_SIZE})")
    origin, direction = origin.contiguous(), direction.contiguous()
    _check("origin", origin, torch.float32, device)
    _check("direction", direction, torch.float32, device)
    _check("tri_planes", planes, torch.float32, device)
    _check("node_boxes", boxes, torch.float32, device)
    _check("node_meta", meta, torch.int32, device)
    _check("order", packed.order, torch.int32, device)
    recs, chunk_boxes, cluster_boxes = record_tables(
        planes, packed.n_tris, _library().vmem_intersect_boxes)
    # The bound and count tensors stay referenced until the launch is
    # enqueued.
    lo, lo_ptr, lo_stride, _lo = kernel_bound(t_min, r, device, "t_min")
    hi, hi_ptr, hi_stride, _hi = kernel_bound(t_max, r, device, "t_max")
    n_live, live_ptr, live_bits, _live = kernel_live(live_count, r, device)

    out = torch.empty(4 * r, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _library().vmem_intersect(
        origin.data_ptr(), direction.data_ptr(), r, lo, lo_ptr, lo_stride,
        hi, hi_ptr, hi_stride, n_live, live_ptr, live_bits, boxes.data_ptr(),
        meta.data_ptr(), recs.data_ptr(), chunk_boxes.data_ptr(),
        cluster_boxes.data_ptr(), int(packed.n_tris), packed.order.data_ptr(),
        int(any_hit), out.data_ptr(), _THREADS, stream)
    if err != 0:
        raise RuntimeError(f"vmem_intersect launch failed: cudaError {err}")
    launch_count += 1
    return Hit(t=out[:r], prim=out[r:2 * r].view(torch.int32),
               u=out[2 * r:3 * r], v=out[3 * r:4 * r])


def vmem_intersect(packed: VmemTriangles, origin, direction, t_min, t_max,
                   any_hit: bool = False, live_count=None) -> Hit:
    """Nearest hit (or any-hit occlusion) of rays [r, 3] through the
    resident-cluster packing; prim ids are original triangle indices. With
    ``any_hit`` only ``prim >= 0`` is defined. Groups of ``GROUP_R`` rays
    that start at an index >= ``live_count`` (int or int tensor) report
    misses untraversed.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    kind = origin.device.type
    if kind == "cuda":
        return vmem_intersect_cuda(packed, origin, direction, t_min, t_max,
                                   any_hit, live_count)
    if kind == "cpu":
        return vmem_intersect_reference(packed, origin, direction, t_min,
                                        t_max, any_hit, live_count)
    raise ValueError(f"no resident-cluster intersect for tensors on "
                     f"{origin.device}")
