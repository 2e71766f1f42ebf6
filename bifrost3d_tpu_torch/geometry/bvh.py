"""Binned-SAH BVH builder (host-side numpy) with a flattened array layout.

Port of ``bifrost3d_tpu/geometry/bvh.py`` (``BVH``, ``build_bvh``,
``build_bvh_boxes``, ``_build_bvh_arrays``, ``_check_stack_depth``,
``refit_bvh``): a standard binned surface-area-heuristic builder producing
a depth-first flattened node array. Building and refitting run on the host
in numpy (or the native C++ builder, ``geometry/native.py``); the arrays
come back as CPU tensors and :meth:`BVH.to` moves them to the scene's
device.

Layout (classic Wald-style flattening):
- ``node_min/node_max [n, 3]`` — AABBs.
- ``node_a [n]`` — leaf: offset into ``prim_indices``; internal: index of
  the RIGHT child (left child is always ``i + 1`` in depth-first order).
- ``node_count [n]`` — leaf: number of primitives (> 0); internal: 0.
- ``prim_indices [t]`` — triangle ids reordered so leaves are contiguous.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

STACK_SIZE = 64     # per-ray traversal stack, plain version and kernel alike
N_BINS = 16
MAX_LEAF_SIZE = 4
TRAVERSAL_COST = 1.0
INTERSECT_COST = 1.0


class BVH(NamedTuple):
    node_min: torch.Tensor      # [n, 3]
    node_max: torch.Tensor      # [n, 3]
    node_a: torch.Tensor        # [n] int32
    node_count: torch.Tensor    # [n] int32 (0 = internal)
    prim_indices: torch.Tensor  # [t] int32

    def to(self, device) -> "BVH":
        return BVH(*(f.to(device) for f in self))

    @staticmethod
    def from_numpy(arrays: dict, *, device) -> "BVH":
        """A BVH from its fields held as numpy arrays."""
        return BVH(*(torch.tensor(np.asarray(
            arrays[name], np.float32 if name in ("node_min", "node_max")
            else np.int32), device=device) for name in BVH._fields))

    @property
    def node_count_total(self) -> int:
        return int(self.node_a.shape[0])

    @property
    def max_depth(self) -> int:
        """Upper bound on traversal stack depth (computed host-side)."""
        a = _np(self.node_a)
        cnt = _np(self.node_count)
        stack = [(0, 1)]
        max_d = 1
        while stack:
            node, d = stack.pop()
            max_d = max(max_d, d)
            if cnt[node] == 0:
                stack.append((node + 1, d + 1))
                stack.append((int(a[node]), d + 1))
        return max_d


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _from_arrays(node_min, node_max, node_a, node_count, prim_order) -> BVH:
    return BVH(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        node_min, node_max, node_a, node_count, prim_order)))


def build_bvh(positions, indices, use_native: bool = True) -> BVH:
    """Build from triangle soup: positions [v, 3], indices [t, 3].

    Uses the C++ builder (native/bvh_builder.cpp via ctypes) when the
    toolchain is available; the numpy path below is the reference
    implementation and fallback.
    """
    pos = np.asarray(positions, np.float64)
    idx = np.asarray(indices, np.int64)
    t = idx.shape[0]
    tri = pos[idx]                                  # [t, 3, 3]
    tri_min = tri.min(axis=1)
    tri_max = tri.max(axis=1)
    centroids = (tri_min + tri_max) * 0.5

    if use_native and t > 0:
        from bifrost3d_tpu_torch.geometry.native import build_bvh_native
        res = build_bvh_native(tri_min.astype(np.float32),
                               tri_max.astype(np.float32), MAX_LEAF_SIZE)
        if res is not None:
            return _check_stack_depth(_from_arrays(*res))

    return _check_stack_depth(
        _build_bvh_arrays(tri_min, tri_max, centroids, MAX_LEAF_SIZE))


def build_bvh_boxes(box_min, box_max, max_leaf: int = 1,
                    use_native: bool = True) -> BVH:
    """Build a BVH over axis-aligned boxes (e.g. triangle-cluster AABBs).

    Same flattened layout as :func:`build_bvh`; ``prim_indices`` holds box
    ids.
    """
    lo = np.asarray(box_min, np.float64)
    hi = np.asarray(box_max, np.float64)
    if use_native and lo.shape[0] > 0:
        from bifrost3d_tpu_torch.geometry.native import build_bvh_native
        res = build_bvh_native(lo.astype(np.float32), hi.astype(np.float32),
                               max_leaf)
        if res is not None:
            return _check_stack_depth(_from_arrays(*res))
    return _check_stack_depth(
        _build_bvh_arrays(lo, hi, (lo + hi) * 0.5, max_leaf))


def _build_bvh_arrays(tri_min, tri_max, centroids, max_leaf: int) -> BVH:
    """Numpy binned-SAH builder over bounding boxes (reference/fallback)."""
    t = tri_min.shape[0]
    # Worst case 2t-1 nodes.
    cap = max(2 * t, 2)
    node_min = np.zeros((cap, 3), np.float32)
    node_max = np.zeros((cap, 3), np.float32)
    node_a = np.zeros(cap, np.int32)
    node_cnt = np.zeros(cap, np.int32)
    prim_order = np.arange(t, dtype=np.int32)
    n_nodes = 0

    def surface(lo, hi):
        d = np.maximum(hi - lo, 0)
        return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                      + d[..., 0] * d[..., 2])

    def emit(first, count):
        """Recursively build the subtree over prim_order[first:first+count];
        returns the node index. Iterative with an explicit stack to survive
        deep meshes."""
        nonlocal n_nodes
        root = n_nodes
        # Work items: (first, count, parent_needing_right_pointer_or_None).
        # Depth-first emission: the left child always lands at parent + 1;
        # the right child's slot is patched into the parent when popped.
        stack = [(first, count, None)]
        while stack:
            first, count, patch_parent = stack.pop()
            me = n_nodes
            n_nodes += 1
            if patch_parent is not None:
                node_a[patch_parent] = me
            sel = prim_order[first:first + count]
            lo = tri_min[sel].min(axis=0)
            hi = tri_max[sel].max(axis=0)
            node_min[me] = lo
            node_max[me] = hi

            split = _find_split(sel, centroids, tri_min, tri_max, lo, hi, surface)
            if count <= max_leaf:
                node_a[me] = first
                node_cnt[me] = count
                continue
            if split is None:
                # SAH found no beneficial split but the leaf would exceed the
                # traversal's fixed leaf bound — median-split the widest axis.
                axis = int(np.argmax(hi - lo))
                keys = centroids[sel, axis]
                order = np.argsort(keys, kind="stable")
                mid = count // 2
                left_ids, right_ids = sel[order[:mid]], sel[order[mid:]]
            else:
                axis, plane, _ = split
                keys = centroids[sel, axis]
                order = np.argsort(keys, kind="stable")
                in_left = keys < plane
                left_ids = sel[in_left]
                right_ids = sel[~in_left]
                if len(left_ids) == 0 or len(right_ids) == 0:
                    mid = count // 2
                    left_ids, right_ids = sel[order[:mid]], sel[order[mid:]]
            prim_order[first:first + len(left_ids)] = left_ids
            prim_order[first + len(left_ids):first + count] = right_ids
            node_cnt[me] = 0
            # Right child pushed first so the left is emitted next (DFS).
            stack.append((first + len(left_ids), len(right_ids), me))
            stack.append((first, len(left_ids), None))
        return root

    def _find_split(sel, centroids, tri_min, tri_max, lo, hi, surface):
        count = len(sel)
        best = None
        best_cost = INTERSECT_COST * count
        cb_lo = centroids[sel].min(axis=0)
        cb_hi = centroids[sel].max(axis=0)
        for axis in range(3):
            if cb_hi[axis] - cb_lo[axis] < 1e-12:
                continue
            scale = N_BINS / (cb_hi[axis] - cb_lo[axis])
            bins = np.minimum(
                ((centroids[sel, axis] - cb_lo[axis]) * scale).astype(np.int64),
                N_BINS - 1)
            bin_cnt = np.bincount(bins, minlength=N_BINS)
            bin_min = np.full((N_BINS, 3), np.inf)
            bin_max = np.full((N_BINS, 3), -np.inf)
            for b in range(N_BINS):
                mask = bins == b
                if mask.any():
                    bin_min[b] = tri_min[sel[mask]].min(axis=0)
                    bin_max[b] = tri_max[sel[mask]].max(axis=0)
            # Sweep: prefix/suffix bounds.
            lmin = np.minimum.accumulate(bin_min, axis=0)
            lmax = np.maximum.accumulate(bin_max, axis=0)
            rmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
            lcnt = np.cumsum(bin_cnt)
            rcnt = count - lcnt
            sa = surface(lo, hi)
            for b in range(N_BINS - 1):
                if lcnt[b] == 0 or rcnt[b] == 0:
                    continue
                cost = (TRAVERSAL_COST
                        + (surface(lmin[b], lmax[b]) * lcnt[b]
                           + surface(rmin[b + 1], rmax[b + 1]) * rcnt[b])
                        * INTERSECT_COST / max(sa, 1e-20))
                if cost < best_cost:
                    best_cost = cost
                    plane = cb_lo[axis] + (b + 1) / scale
                    best = (axis, plane, int(lcnt[b]))
        return best

    emit(0, t)

    return _from_arrays(node_min[:n_nodes], node_max[:n_nodes],
                        node_a[:n_nodes], node_cnt[:n_nodes], prim_order)


def build_soup_bvh(tri_verts) -> BVH:
    """The BVH over a [t, 3, 3] soup (numpy array or tensor on any device),
    built on the host: every triangle its own three vertices."""
    if isinstance(tri_verts, torch.Tensor):
        tri_verts = tri_verts.detach().cpu().numpy()
    flat = np.asarray(tri_verts).reshape(-1, 3)
    return build_bvh(flat, np.arange(flat.shape[0],
                                     dtype=np.int32).reshape(-1, 3))


def _check_stack_depth(bvh: BVH) -> BVH:
    """Refuse to hand back a tree deeper than the traversal stack.

    The plain traversal and the CUDA kernel use a fixed per-ray stack
    (``STACK_SIZE``); a deeper tree would silently drop pushed nodes and return wrong hits.
    Binned-SAH trees with 4-triangle leaves stay far below the limit, so
    exceeding it means a pathological input — fail loudly at build time.
    """
    depth = bvh.max_depth
    if depth + 1 > STACK_SIZE:
        raise ValueError(
            f"BVH depth {depth} exceeds the traversal stack "
            f"(STACK_SIZE={STACK_SIZE}); the input mesh is pathological "
            "(e.g. a long chain of coincident triangles). Split or clean "
            "the mesh.")
    return bvh


def refit_bvh(bvh: BVH, positions, indices) -> BVH:
    """Recompute node AABBs for MOVED geometry, keeping the tree topology
    and primitive order — the reference's refit-able top-level accel
    (OptiXRenderer/Renderer.cpp:1010-1041): a transform edit must not pay
    a SAH rebuild.

    Vectorized bottom-up: leaf boxes via segmented reductions over the
    DFS-contiguous primitive slices, internal boxes by level (deepest
    first; the preorder layout guarantees children have larger indices and
    strictly larger depth than their parent).
    """
    pos = np.asarray(positions, np.float64)
    idx = np.asarray(indices, np.int64)
    tri = pos[idx]
    tmin = tri.min(axis=1).astype(np.float32)
    tmax = tri.max(axis=1).astype(np.float32)

    a = _np(bvh.node_a)
    cnt = _np(bvh.node_count)
    order = _np(bvh.prim_indices)
    n = a.shape[0]
    nmin = np.zeros((n, 3), np.float32)
    nmax = np.zeros((n, 3), np.float32)

    # Leaves: prim slices [a, a+cnt) over `order` are DFS-contiguous —
    # segmented min/max via reduceat on the slice starts (sorted by start).
    leaves = np.flatnonzero(cnt > 0)
    if leaves.size:
        by_start = leaves[np.argsort(a[leaves], kind="stable")]
        starts = a[by_start]
        pm_min = tmin[order]
        pm_max = tmax[order]
        nmin[by_start] = np.minimum.reduceat(pm_min, starts, axis=0)
        nmax[by_start] = np.maximum.reduceat(pm_max, starts, axis=0)

    # Node depths in one vectorized frontier sweep.
    internal = cnt == 0
    depth = np.zeros(n, np.int32)
    frontier = np.asarray([0], np.int64)
    d = 0
    while frontier.size:
        depth[frontier] = d
        inner = frontier[internal[frontier]]
        frontier = np.concatenate([inner + 1, a[inner].astype(np.int64)])
        d += 1

    # Internal boxes, deepest level first.
    for lvl in range(d - 1, -1, -1):
        nodes = np.flatnonzero(internal & (depth == lvl))
        if nodes.size == 0:
            continue
        left = nodes + 1
        right = a[nodes]
        nmin[nodes] = np.minimum(nmin[left], nmin[right])
        nmax[nodes] = np.maximum(nmax[left], nmax[right])

    device = bvh.node_a.device
    return bvh._replace(node_min=torch.from_numpy(nmin).to(device),
                        node_max=torch.from_numpy(nmax).to(device))
