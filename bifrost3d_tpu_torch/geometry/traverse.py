"""Ray–triangle intersection and the scene-query dispatch.

Port of the dense part of ``bifrost3d_tpu/geometry/traverse.py`` (``Hit``,
``moller_trumbore``, ``intersect_triangles_brute``, ``intersect_scene``,
``intersect_scene_any``). The BVH traversal is not on the slice: a scene of
at most ``PALLAS_MAX_TRIS`` triangles always traces dense.

Scene queries go to ``geometry/pallas_intersect.pallas_intersect``, which
dispatches by the tensors' device, never by global state:

- CUDA tensors → the hand-written CUDA kernel, at any ray count;
- CPU tensors → its plain PyTorch version;
- anything else, a scene without packed triangles or one over
  ``PALLAS_MAX_TRIS``, raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bifrost3d_tpu_torch.math.vec import cross

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
    e1 = v1 - v0
    e2 = v2 - v0
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


def intersect_scene(triangles, origin, direction, t_min=1e-4,
                    t_max=float("inf"), tri_components=None) -> Hit:
    """Nearest hit of rays [r, 3] against the scene's triangle soup.

    ``tri_components`` is the packed (v0, e1, e2) table of
    :func:`~bifrost3d_tpu_torch.geometry.pallas_intersect.pack_triangles`,
    which every RenderScene carries.
    """
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense

    n_tris = int(triangles.shape[0])
    if tri_components is None:
        raise ValueError("scene queries need the packed tri_components "
                         "table (pack_triangles)")
    if n_tris > PALLAS_MAX_TRIS:
        raise NotImplementedError(
            f"scenes over {PALLAS_MAX_TRIS} triangles need the BVH trace "
            "kernels, which are not ported yet")
    return dense.pallas_intersect(tri_components, n_tris, origin, direction,
                                  t_min, t_max)


def intersect_scene_any(triangles, origin, direction, t_min=1e-4,
                        t_max=float("inf"), tri_components=None):
    """Occlusion: True where any triangle lies in (t_min, t_max). Runs the
    closest-hit query, as the TPU kernel does (no early exit)."""
    hit = intersect_scene(triangles, origin, direction, t_min, t_max,
                          tri_components=tri_components)
    return hit.prim >= 0
