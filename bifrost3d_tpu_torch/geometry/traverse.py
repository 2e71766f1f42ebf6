"""Ray–triangle and ray–BVH intersection, and the scene-query dispatch.

Port of ``bifrost3d_tpu/geometry/traverse.py`` (``Hit``,
``moller_trumbore``, ``intersect_triangles_brute``, ``intersect_bvh``,
``intersect_bvh_any``, ``intersect_scene``, ``intersect_scene_any``).

:func:`intersect_bvh` is the lockstep stack traversal: every ray keeps a
fixed stack and all rays advance one node per step of a Python loop
(JAX's ``while_loop``), finished lanes idling under masks until the
slowest one is done. It is the plain version of the BVH trace kernel
(``geometry/pallas_bvh.py``) and the reference the kernel is held to.

Scene queries dispatch on what the scene carries and on the device of the
tensors, never on global state:

- a scene with a packing in ``tri_clustered`` → by the packing's type:
  ``VmemTriangles`` → ``pallas_bvh_vmem.vmem_intersect``, ``HierTriangles``
  (the default over ``PALLAS_MAX_TRIS`` triangles) →
  ``pallas_bvh.hierarchical_intersect``, else (``ClusteredTriangles``) →
  ``pallas_clustered.clustered_intersect``; each is its CUDA kernel on CUDA
  tensors and its plain version on CPU tensors;
- a scene with the dense table (``tri_components``) →
  ``pallas_intersect.pallas_intersect``: the CUDA dense kernel on CUDA
  tensors, its plain version on CPU tensors;
- a scene with neither → the lockstep traversal over ``bvh``, or brute
  force without one.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from bifrost3d_tpu_torch.geometry.bvh import BVH, MAX_LEAF_SIZE, STACK_SIZE
from bifrost3d_tpu_torch.math.vec import cross

# Up to this many triangles a scene is packed for the dense kernel; above
# it for the BVH kernel.
PALLAS_MAX_TRIS = 65536
_BRUTE_CHUNK = 512


class Hit(NamedTuple):
    t: torch.Tensor     # [...] distance (inf on miss)
    prim: torch.Tensor  # [...] int32 triangle id (-1 on miss)
    u: torch.Tensor     # [...] barycentric u (of vertex 1)
    v: torch.Tensor     # [...] barycentric v (of vertex 2)

    @property
    def mask(self):
        return torch.isfinite(self.t)


def moller_trumbore(origin, direction, v0, v1, v2, eps=1e-9):
    """Double-sided Möller–Trumbore over broadcastable batches
    → (t, u, v, hit_mask)."""
    return moller_trumbore_edges(origin, direction, v0, v1 - v0, v2 - v0, eps)


def moller_trumbore_edges(origin, direction, v0, e1, e2, eps=1e-9):
    """:func:`moller_trumbore` for a triangle given as (v0, e1, e2)."""
    pvec = cross(direction, e2)
    det = torch.sum(e1 * pvec, dim=-1)
    inv_det = torch.where(torch.abs(det) > eps,
                          1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tvec = origin - v0
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = cross(tvec, e1)
    v = torch.sum(direction * qvec, dim=-1) * inv_det
    t = torch.sum(e2 * qvec, dim=-1) * inv_det
    hit = ((torch.abs(det) > eps) & (u >= 0.0) & (v >= 0.0)
           & (u + v <= 1.0) & (t > 0.0))
    return t, u, v, hit


def ray_bounds(value, r, origin):
    """A scalar or [r] tensor bound → float32 [r] on origin's device."""
    if isinstance(value, torch.Tensor):
        return torch.broadcast_to(value.to(torch.float32), (r,))
    return torch.full((r,), float(value), dtype=torch.float32,
                      device=origin.device)


def intersect_triangles_brute(triangles, origin, direction, t_min=1e-4,
                              t_max=float("inf")) -> Hit:
    """Dense rays × all-triangles nearest hit; triangles [t, 3, 3],
    origin/direction [r, 3], in chunks of 512 triangles."""
    r = origin.shape[0]
    best_t = ray_bounds(t_max, r, origin)
    best_prim = torch.full((r,), -1, dtype=torch.int32, device=origin.device)
    best_u = torch.zeros(r, device=origin.device)
    best_v = torch.zeros(r, device=origin.device)
    t_min = ray_bounds(t_min, r, origin)[:, None]
    o = origin[:, None, :]
    d = direction[:, None, :]
    for start in range(0, triangles.shape[0], _BRUTE_CHUNK):
        chunk = triangles[start:start + _BRUTE_CHUNK]
        t, u, v, hit = moller_trumbore(o, d, chunk[None, :, 0],
                                       chunk[None, :, 1], chunk[None, :, 2])
        valid = hit & (t > t_min) & (t < best_t[:, None])
        t = torch.where(valid, t, float("inf"))
        k = torch.argmin(t, dim=1, keepdim=True)
        t_new = torch.gather(t, 1, k)[:, 0]
        closer = t_new < best_t
        best_t = torch.where(closer, t_new, best_t)
        best_prim = torch.where(closer, (k[:, 0] + start).to(torch.int32),
                                best_prim)
        best_u = torch.where(closer, torch.gather(u, 1, k)[:, 0], best_u)
        best_v = torch.where(closer, torch.gather(v, 1, k)[:, 0], best_v)
    miss = best_prim < 0
    return Hit(t=torch.where(miss, float("inf"), best_t), prim=best_prim,
               u=best_u, v=best_v)


def intersect_scene(bvh: Optional[BVH], triangles, origin, direction,
                    t_min=1e-4, t_max=float("inf"), any_hit: bool = False,
                    tri_components=None, tri_clustered=None,
                    live_count=None) -> Hit:
    """Nearest hit of rays [r, 3] against the scene's triangle soup (with
    ``any_hit`` only ``prim >= 0`` is defined).

    ``tri_clustered`` is the packing of
    :func:`~bifrost3d_tpu_torch.geometry.pallas_bvh.pack_hierarchical`,
    :func:`~bifrost3d_tpu_torch.geometry.pallas_bvh_vmem.pack_vmem` or
    :func:`~bifrost3d_tpu_torch.geometry.pallas_clustered.pack_clustered`
    and ``tri_components`` the dense table of
    :func:`~bifrost3d_tpu_torch.geometry.pallas_intersect.pack_triangles`;
    a RenderScene carries one of the two. ``live_count`` (int or int
    tensor, optional): rays at an index >= it are known to be inactive and
    report misses untraversed. The cluster scan has neither an any-hit
    mode nor a live prefix: it answers both with its closest hit.
    """
    if tri_clustered is not None:
        from bifrost3d_tpu_torch.geometry.pallas_bvh import (
            HierTriangles, hierarchical_intersect)
        from bifrost3d_tpu_torch.geometry.pallas_bvh_vmem import (
            VmemTriangles, vmem_intersect)
        if isinstance(tri_clustered, VmemTriangles):
            return vmem_intersect(tri_clustered, origin, direction, t_min,
                                  t_max, any_hit=any_hit,
                                  live_count=live_count)
        if isinstance(tri_clustered, HierTriangles):
            return hierarchical_intersect(tri_clustered, origin, direction,
                                          t_min, t_max, any_hit=any_hit,
                                          live_count=live_count)
        from bifrost3d_tpu_torch.geometry.pallas_clustered import (
            clustered_intersect)
        return clustered_intersect(tri_clustered, origin, direction, t_min,
                                   t_max)
    if tri_components is not None:
        from bifrost3d_tpu_torch.geometry.pallas_intersect import (
            pallas_intersect)
        return pallas_intersect(tri_components, int(triangles.shape[0]),
                                origin, direction, t_min, t_max,
                                live_count=live_count)
    if bvh is None:
        return intersect_triangles_brute(triangles, origin, direction,
                                         t_min, t_max)
    return intersect_bvh(bvh, triangles, origin, direction, t_min, t_max,
                         any_hit=any_hit)


def intersect_scene_any(bvh: Optional[BVH], triangles, origin, direction,
                        t_min=1e-4, t_max=float("inf"), tri_components=None,
                        tri_clustered=None, live_count=None):
    """Occlusion: True where any triangle lies in (t_min, t_max)."""
    hit = intersect_scene(bvh, triangles, origin, direction, t_min, t_max,
                          any_hit=True, tri_components=tri_components,
                          tri_clustered=tri_clustered, live_count=live_count)
    return hit.prim >= 0


def _aabb_hit(origin, inv_dir, lo, hi, t_max):
    """Slab test: does the ray segment [0, t_max] hit the box (lo, hi)?"""
    t0 = (lo - origin) * inv_dir
    t1 = (hi - origin) * inv_dir
    t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
    return (t_near <= t_far) & (t_far > 0.0) & (t_near < t_max)


def traverse_lockstep(node_min, node_max, node_a, node_count, fetch_leaf,
                      origin, direction, t_min, t_max, any_hit: bool = False,
                      live_count=None, stats: Optional[dict] = None) -> Hit:
    """The lockstep traversal over a flattened BVH.

    ``fetch_leaf(slot [r, K] int64) -> (v0, e1, e2 [r, K, 3], prim [r, K]
    int32)`` returns the triangles at leaf-order slots. Each step pops one
    node per active ray, tests its box against the ray's running best,
    tests the ≤ ``MAX_LEAF_SIZE`` triangles of a leaf or pushes both
    children (left = node + 1 popped first). Ties keep the first-found
    hit: strict '<' across leaves, the lowest slot inside one.

    A ``stats`` dict, if given, receives this walk's work as tensors:
    ``steps``, ``box_tests`` (nodes popped), ``tri_tests`` (triangles of
    the leaves entered), and the distinct memory behind them:
    ``unique_nodes`` (nodes popped by at least one ray),
    ``unique_internal`` (internal nodes entered by at least one ray: the
    child records a kernel reads) and ``unique_tris`` (triangles of the
    leaves entered by at least one ray).
    """
    r = origin.shape[0]
    device = origin.device
    # Clamp tiny components so the slab test stays NaN-free (conservative:
    # a near-axis-parallel ray sees slightly fat slabs, never thin ones).
    d_safe = torch.where(torch.abs(direction) < 1e-12,
                         torch.where(direction < 0, -1e-12, 1e-12), direction)
    inv_dir = 1.0 / d_safe
    t_lo = ray_bounds(t_min, r, origin)

    stack = torch.zeros((r, STACK_SIZE), dtype=torch.int64, device=device)
    sp = torch.ones(r, dtype=torch.int64, device=device)  # root pre-pushed
    if live_count is not None:
        sp = torch.where(torch.arange(r, device=device) < live_count, sp, 0)
    best_t = ray_bounds(t_max, r, origin).clone()
    best_prim = torch.full((r,), -1, dtype=torch.int32, device=device)
    best_u = torch.zeros(r, device=device)
    best_v = torch.zeros(r, device=device)
    ks = torch.arange(MAX_LEAF_SIZE, device=device)
    steps = 0
    box_tests = torch.zeros((), dtype=torch.int64, device=device)
    tri_tests = torch.zeros((), dtype=torch.int64, device=device)
    if stats is not None:
        node_seen = torch.zeros(node_a.shape[0], dtype=torch.bool,
                                device=device)
        leaf_seen = torch.zeros_like(node_seen)
        inner_seen = torch.zeros_like(node_seen)

    while bool((sp > 0).any().item()):
        active = sp > 0
        top = torch.clamp(sp - 1, 0, STACK_SIZE - 1)
        node = torch.gather(stack, 1, top[:, None])[:, 0]
        node = torch.where(active, node, 0)
        sp = torch.where(active, sp - 1, sp)

        box_hit = _aabb_hit(origin, inv_dir, node_min[node], node_max[node],
                            best_t) & active
        a = node_a[node].to(torch.int64)
        count = node_count[node].to(torch.int64)
        is_leaf = count > 0

        # Leaf: test its triangles.
        do_leaf = box_hit & is_leaf
        if stats is not None:
            steps += 1
            box_tests = box_tests + active.sum()
            tri_tests = tri_tests + torch.where(do_leaf, count, 0).sum()
            node_seen[node[active]] = True
            leaf_seen[node[do_leaf]] = True
        slot = a[:, None] + ks[None, :]
        v0, e1, e2, prim_ids = fetch_leaf(torch.where(do_leaf[:, None], slot, 0))
        t, u, v, hit = moller_trumbore_edges(origin[:, None, :],
                                             direction[:, None, :], v0, e1, e2)
        valid = (hit & (ks[None, :] < count[:, None]) & do_leaf[:, None]
                 & (t > t_lo[:, None]) & (t < best_t[:, None]))
        t = torch.where(valid, t, float("inf"))
        k_best = torch.argmin(t, dim=1, keepdim=True)
        t_new = torch.gather(t, 1, k_best)[:, 0]
        closer = t_new < best_t
        best_t = torch.where(closer, t_new, best_t)
        best_prim = torch.where(closer, torch.gather(prim_ids, 1, k_best)[:, 0],
                                best_prim)
        best_u = torch.where(closer, torch.gather(u, 1, k_best)[:, 0], best_u)
        best_v = torch.where(closer, torch.gather(v, 1, k_best)[:, 0], best_v)
        if any_hit:
            # Occlusion query: a hit empties the lane's stack.
            sp = torch.where(best_prim >= 0, 0, sp)

        # Internal: push both children (left = node + 1, right = node_a).
        push = box_hit & ~is_leaf
        if stats is not None:
            inner_seen[node[push]] = True
        slot0 = torch.clamp(sp, 0, STACK_SIZE - 1)[:, None]
        stack.scatter_(1, slot0, torch.where(
            push, a, torch.gather(stack, 1, slot0)[:, 0])[:, None])
        sp = torch.where(push, torch.clamp_max(sp + 1, STACK_SIZE), sp)
        slot1 = torch.clamp(sp, 0, STACK_SIZE - 1)[:, None]
        stack.scatter_(1, slot1, torch.where(
            push, node + 1, torch.gather(stack, 1, slot1)[:, 0])[:, None])
        sp = torch.where(push, torch.clamp_max(sp + 1, STACK_SIZE), sp)

    if stats is not None:
        stats.update(steps=steps, box_tests=box_tests, tri_tests=tri_tests,
                     unique_nodes=node_seen.sum(),
                     unique_internal=inner_seen.sum(),
                     unique_tris=node_count[leaf_seen].sum())
    miss = best_prim < 0
    return Hit(t=torch.where(miss, float("inf"), best_t), prim=best_prim,
               u=torch.where(miss, 0.0, best_u),
               v=torch.where(miss, 0.0, best_v))


def intersect_bvh(bvh: BVH, triangles, origin, direction, t_min=1e-4,
                  t_max=float("inf"), any_hit: bool = False) -> Hit:
    """Nearest-hit (or any-hit) BVH traversal for rays [r, 3]; triangles
    [t, 3, 3] are the gathered vertex positions the tree was built over."""
    prim_indices = bvh.prim_indices
    last = prim_indices.shape[0] - 1

    def fetch_leaf(slot):
        prim_ids = prim_indices[torch.clamp_max(slot, last)]
        tris = triangles[prim_ids.long()]                   # [r, K, 3, 3]
        v0 = tris[:, :, 0]
        return v0, tris[:, :, 1] - v0, tris[:, :, 2] - v0, prim_ids

    return traverse_lockstep(bvh.node_min, bvh.node_max, bvh.node_a,
                             bvh.node_count, fetch_leaf, origin, direction,
                             t_min, t_max, any_hit=any_hit)


def intersect_bvh_any(bvh: BVH, triangles, origin, direction, t_min=1e-4,
                      t_max=float("inf")):
    """Occlusion query: True where any triangle lies in (t_min, t_max)."""
    hit = intersect_bvh(bvh, triangles, origin, direction, t_min, t_max,
                        any_hit=True)
    return hit.prim >= 0
