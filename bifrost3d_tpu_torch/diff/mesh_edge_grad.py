"""Edge-sampled (boundary) geometry gradients for triangle meshes.

Port of ``bifrost3d_tpu/diff/mesh_edge_grad.py``. The derivative of an
image functional with respect to an object's translation has a contour
integral along the object's silhouette edges (Li et al. 2018,
"Differentiable Monte Carlo Ray Tracing through Edge Sampling") that
pathwise autodiff misses: radiance is discontinuous across a silhouette.
For a discontinuity curve q(s) in the unit image square moving with
velocity V_j = ∂q/∂t_j under translation component t_j,

    d(mean)/dt_j = Σ_edges ∫₀¹ (L₋ − L₊) · det[dq/ds, V_j] ds

where L∓ are the radiances probed just on either side of the projected
edge along its image normal n̂ = perp(dq/ds)/|dq/ds| (L₋ on the −n̂
side). Flipping an edge flips both det and the probe sides, so the sign
needs no orientation. Everything is vectorized over edges × samples, and
occlusion needs no special case: a hidden edge point probes the same
radiance on both sides and cancels.

- primary silhouettes under object translation
  (:func:`edge_translation_gradient`) and under per-vertex motion
  (:func:`edge_vertex_gradient`: the same integral with velocity
  ∂q/∂v = the barycentric share of ∂q/∂x, added to each vertex);
- shadow silhouettes (:func:`shadow_edge_translation_gradient`): the
  light-silhouette edge reprojected through the light onto a receiver
  plane, its velocity chained through that intersection.

JAX's per-sample ``jax.jvp`` / ``jax.jacfwd`` under ``jax.vmap`` become
batched ``torch.func.jvp`` calls, one per tangent direction (along the
edge, then the three axes): each sample's map depends on its own point
only.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jvp

from bifrost3d_tpu_torch.scene.camera import (
    PinholeCamera,
    camera_ray_directions,
    project_to_screen,
)


class MeshEdges(NamedTuple):
    """Unique edges of a triangle mesh with their adjacent faces' normals,
    built on the host once per object (:meth:`build`); translation leaves
    them unchanged, so one build serves every gradient evaluation."""

    v0: torch.Tensor   # [e, 3] edge start (object space)
    v1: torch.Tensor   # [e, 3] edge end
    n0: torch.Tensor   # [e, 3] normal of one adjacent face
    n1: torch.Tensor   # [e, 3] normal of the other (-n0 for a boundary
                       #        edge, which is always a silhouette)
    i0: torch.Tensor   # [e] int32 canonical vertex id of v0 (the first
    i1: torch.Tensor   # [e] int32     occurrence of the merged position)

    @staticmethod
    def build(positions, indices, *, device) -> "MeshEdges":
        pos = np.asarray(positions, np.float64)
        idx = np.asarray(indices, np.int64).reshape(-1, 3)
        # Merge positionally duplicate vertices: meshes with per-face
        # normals or uvs (make_box) duplicate corners, which would turn
        # every shared edge into two boundary edges and count its
        # silhouette twice.
        _, first_idx, uniq_inverse = np.unique(
            pos.round(decimals=5), axis=0,
            return_index=True, return_inverse=True)
        idx = first_idx[uniq_inverse.reshape(-1)][idx]
        all_edges = np.concatenate([idx[:, [0, 1]], idx[:, [1, 2]],
                                    idx[:, [2, 0]]], axis=0)     # [3f, 2]
        face_of = np.tile(np.arange(idx.shape[0]), 3)
        key = np.sort(all_edges, axis=1)

        tri = pos[idx]
        fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-20)

        v0_list, v1_list, n0_list, n1_list = [], [], [], []
        i0_list, i1_list = [], []
        order = np.lexsort((key[:, 1], key[:, 0]))
        sorted_key = key[order]
        sorted_face = face_of[order]
        sorted_orig = all_edges[order]
        i = 0
        while i < len(sorted_key):
            j = i + 1
            while j < len(sorted_key) and np.all(
                    sorted_key[j] == sorted_key[i]):
                j += 1
            a, b = sorted_orig[i]
            n0 = fn[sorted_face[i]]
            if j - i >= 2:
                n1 = fn[sorted_face[i + 1]]
                if np.dot(np.cross(n0, n1), np.cross(n0, n1)) < 1e-16:
                    i = j
                    continue          # a coplanar interior edge is never a
                                      # silhouette: skip it
            else:
                n1 = -n0              # a boundary edge always is
            v0_list.append(pos[a])
            v1_list.append(pos[b])
            n0_list.append(n0)
            n1_list.append(n1)
            i0_list.append(a)
            i1_list.append(b)
            i = j

        def t(values, dtype):
            return torch.tensor(np.asarray(values, dtype), device=device)

        return MeshEdges(v0=t(v0_list, np.float32), v1=t(v1_list, np.float32),
                         n0=t(n0_list, np.float32), n1=t(n1_list, np.float32),
                         i0=t(i0_list, np.int32), i1=t(i1_list, np.int32))


def _edge_samples(edges: MeshEdges, translation, k: int):
    """→ (s [k], sample points [e, k, 3], the edges' directions repeated per
    sample [e·k, 3]) at stratified parameters s along each edge."""
    translation = torch.as_tensor(translation, dtype=torch.float32,
                                  device=edges.v0.device)
    s = (torch.arange(k, dtype=torch.float32, device=edges.v0.device)
         + 0.5) / k
    p0 = edges.v0 + translation
    p1 = edges.v1 + translation
    x = p0[:, None, :] + (p1 - p0)[:, None, :] * s[None, :, None]
    return s, x, torch.repeat_interleave(p1 - p0, k, dim=0)


def _silhouette(x, eye, edges: MeshEdges):
    """Silhouette seen from ``eye`` at each sample (the view vector varies
    along the edge): one adjacent face front-facing, the other back → [e·k]."""
    view = x - eye
    side0 = torch.einsum("ekc,ec->ek", view, edges.n0)
    side1 = torch.einsum("ekc,ec->ek", view, edges.n1)
    return (side0 * side1 <= 0.0).reshape(-1)


def _screen_derivatives(q_of, points, tangent):
    """Forward mode over every sample at once → (q [m, 2], w [m], dq along
    ``tangent`` [m, 2], dq/dx [m, 2, 3])."""
    (q, w), (dq_ds, _) = jvp(q_of, (points,), (tangent,))
    dq_dx = torch.stack([
        jvp(lambda p: q_of(p)[0], (points,), (axis.expand_as(points),))[1]
        for axis in torch.eye(3, device=points.device)], dim=-1)
    return q, w, dq_ds, dq_dx


def _edge_jump(camera: PinholeCamera, radiance_fn, q, w, dq_ds,
               edge_eps: float):
    """Radiance just on the −n̂ side minus just on the +n̂ side of the
    projected edge → (ΔL [m], inside the image [m])."""
    inside = (w > 0.0) & torch.all((q >= 0.0) & (q <= 1.0), dim=-1)
    t_len = torch.sqrt(torch.sum(dq_ds * dq_ds, dim=-1))
    n_img = torch.stack([-dq_ds[:, 1], dq_ds[:, 0]], dim=-1) \
        / torch.clamp_min(t_len, 1e-12)[:, None]
    o_m, d_m = camera_ray_directions(
        camera, torch.clamp(q - edge_eps * n_img, 0.0, 1.0))
    o_p, d_p = camera_ray_directions(
        camera, torch.clamp(q + edge_eps * n_img, 0.0, 1.0))
    return radiance_fn(o_m, d_m) - radiance_fn(o_p, d_p), inside


def _det(dq_ds, dq_dx):
    """det[dq/ds, dq/dx_j] per axis j → [m, 3]."""
    return dq_ds[:, 0, None] * dq_dx[:, 1, :] \
        - dq_ds[:, 1, None] * dq_dx[:, 0, :]


@torch.no_grad()
def edge_translation_gradient(camera: PinholeCamera, edges: MeshEdges,
                              translation, radiance_fn,
                              samples_per_edge: int = 8,
                              edge_eps: float = 1e-3):
    """Boundary term of d(mean channel-mean image)/d(object translation)
    → [3].

    ``translation`` [3] is the object's current translation (the edge
    vertices are in object space; the probed scene must hold the object
    there). ``radiance_fn(origin, direction) -> [...]`` returns the
    channel-mean radiance the forward functional integrates over the
    image.
    """
    e, k = edges.v0.shape[0], samples_per_edge
    _, x, edge_dir = _edge_samples(edges, translation, k)
    silhouette = _silhouette(x, camera.transform.translation, edges)
    q, w, dq_ds, dq_dt = _screen_derivatives(
        lambda p: project_to_screen(camera, p), x.reshape(-1, 3), edge_dir)
    delta_l, inside = _edge_jump(camera, radiance_fn, q, w, dq_ds, edge_eps)
    weight = torch.where(silhouette & inside, delta_l, 0.0)[:, None]
    # Σ_edges mean_s: each edge integrates ds over [0, 1].
    return torch.sum((weight * _det(dq_ds, dq_dt)).reshape(e, k, 3),
                     dim=(0, 1)) / k


@torch.no_grad()
def edge_vertex_gradient(camera: PinholeCamera, edges: MeshEdges,
                         translation, radiance_fn, n_vertices: int,
                         samples_per_edge: int = 8,
                         edge_eps: float = 1e-3):
    """Boundary term of d(mean channel-mean image)/d(vertex positions) →
    [n_vertices, 3].

    The integral of :func:`edge_translation_gradient` with velocity
    V = ∂q/∂v_j: a sample at parameter s moves with (1−s)·∂q/∂x under its
    edge's start vertex and s·∂q/∂x under its end vertex, so its
    contribution is added to the edge's two canonical vertices (duplicated
    corners accumulate on the first occurrence of the position, as
    :meth:`MeshEdges.build` merges them).
    """
    k = samples_per_edge
    s, x, edge_dir = _edge_samples(edges, translation, k)
    silhouette = _silhouette(x, camera.transform.translation, edges)
    q, w, dq_ds, dq_dx = _screen_derivatives(
        lambda p: project_to_screen(camera, p), x.reshape(-1, 3), edge_dir)
    delta_l, inside = _edge_jump(camera, radiance_fn, q, w, dq_ds, edge_eps)
    delta_l = torch.where(silhouette & inside, delta_l, 0.0)
    contrib = delta_l[:, None] * _det(dq_ds, dq_dx) / k          # [e·k, 3]
    s_flat = s.repeat(edges.v0.shape[0])
    g = torch.zeros((n_vertices, 3), dtype=torch.float32,
                    device=edges.v0.device)
    g.index_add_(0, torch.repeat_interleave(edges.i0.long(), k),
                 contrib * (1.0 - s_flat)[:, None])
    g.index_add_(0, torch.repeat_interleave(edges.i1.long(), k),
                 contrib * s_flat[:, None])
    return g


@torch.no_grad()
def shadow_edge_translation_gradient(camera: PinholeCamera,
                                     edges: MeshEdges, translation,
                                     light_position, radiance_fn,
                                     occluder_fn,
                                     samples_per_edge: int = 8,
                                     edge_eps: float = 1e-3):
    """Shadow-silhouette boundary term of d(mean image)/d(translation) →
    [3], for a point-like light.

    A blocker edge that is a silhouette seen from ``light_position`` casts
    a shadow boundary onto the receiver behind it: q(s) = project(y(s)),
    with y the light ray through the edge point continued to the receiver;
    translating the blocker moves y by the chain rule through the receiver
    plane, which is held fixed. ``occluder_fn(origin, direction) -> (t,
    plane_point [.., 3], plane_normal [.., 3])`` returns the receiver hit
    of a ray cast from just past the edge point away from the light.
    ``radiance_fn`` probes camera rays as for the primary term.
    """
    e, k = edges.v0.shape[0], samples_per_edge
    _, x, edge_dir = _edge_samples(edges, translation, k)
    light = torch.as_tensor(light_position, dtype=torch.float32,
                            device=x.device)
    silhouette = _silhouette(x, light, edges)      # seen from the light
    x = x.reshape(-1, 3)

    # The receiver plane behind each edge point.
    ldir = x - light
    ldist = torch.sqrt(torch.sum(ldir * ldir, dim=-1, keepdim=True))
    ldir = ldir / torch.clamp_min(ldist, 1e-12)
    probe_o = x + ldir * torch.clamp_min(ldist, 1e-12) * 1e-3
    r_t, r_point, r_normal = occluder_fn(probe_o, ldir)
    has_receiver = torch.isfinite(r_t)

    def shadow_point(p):
        """The light ray through p intersected with its receiver plane."""
        d = p - light
        denom = torch.sum(d * r_normal, dim=-1, keepdim=True)
        tt = torch.sum((r_point - light) * r_normal, dim=-1, keepdim=True) \
            / torch.where(torch.abs(denom) > 1e-12, denom, 1e-12)
        return light + d * tt

    q, w, dq_ds, dq_dt = _screen_derivatives(
        lambda p: project_to_screen(camera, shadow_point(p)), x, edge_dir)
    delta_l, inside = _edge_jump(camera, radiance_fn, q, w, dq_ds, edge_eps)
    delta_l = torch.where(silhouette & inside & has_receiver, delta_l, 0.0)
    return torch.sum((delta_l[:, None] * _det(dq_ds, dq_dt)).reshape(e, k, 3),
                     dim=(0, 1)) / k
