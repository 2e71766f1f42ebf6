"""Edge-sampled (boundary) geometry gradients for analytic sphere scenes.

Port of ``bifrost3d_tpu/diff/edge_grad.py``. The pathwise gradient of a
path-traced image with respect to an object's position misses the
visibility boundary term: radiance is piecewise constant across a
silhouette, so ``d/dθ ∫ L`` has a contour integral ``∮ (L_in − L_out)
(v·n̂) dl`` along each silhouette (Li et al. 2018, "Differentiable Monte
Carlo Ray Tracing through Edge Sampling"). This module samples the
silhouettes of the SmallPT sphere scene:

- a sphere's silhouette seen from the pinhole is a circle of directions
  ω(φ) on the cone around ŵ = (c − o)/|c − o| with half-angle
  α = asin(r/|c − o|), differentiable in the sphere's center c;
- ω is projected to image coordinates q(φ, c) ∈ [0,1]² by solving the
  3×3 system s·ω = cam_d + a·cx + b·cy (the inverse of
  ``smallpt_camera_ray``);
- the mean image is the area integral of radiance over the image square,
  so d(mean)/dc = ∮ ΔL̄(φ) · det[∂q/∂φ, ∂q/∂c] dφ, with ΔL̄ the
  channel-mean radiance jump across the edge, probed by rays just inside
  and outside the cone (an occluded arc probes the occluder on both sides
  and cancels).

JAX's per-sample ``jax.jvp`` / ``jax.jacfwd`` under ``jax.vmap`` become
batched ``torch.func.jvp`` calls, one per tangent direction (φ, then the
three axes of c): each sample depends on its own φ only, so a batched
tangent gives every sample's derivative at once.
"""

from __future__ import annotations

import math

import torch
from torch.func import jvp

from bifrost3d_tpu_torch.integrator.smallpt import (
    camera_frame,
    smallpt_camera_ray,
)
from bifrost3d_tpu_torch.math.vec import cross, normalize
from bifrost3d_tpu_torch.scene.spheres import SphereScene, intersect_spheres


def silhouette_direction(center, radius, cam_o, phi, delta_angle=0.0):
    """Unit directions [..., 3] from the pinhole ``cam_o`` [3] to the
    silhouette points at angles ``phi`` [...], with the cone half-angle
    offset by ``delta_angle`` (negative: just inside the sphere, positive:
    just outside). Differentiable in ``center`` [3]."""
    w = center - cam_o
    dist = torch.sqrt(torch.sum(w * w))
    w_hat = w / dist
    sin_a = torch.clamp(radius / dist, 0.0, 1.0 - 1e-7)
    alpha = torch.arcsin(sin_a) + delta_angle
    # A fixed-convention tangent basis, differentiable in w_hat.
    up = torch.where(torch.abs(w_hat[0]) > 0.9,
                     w_hat.new_tensor([0.0, 1.0, 0.0]),
                     w_hat.new_tensor([1.0, 0.0, 0.0]))
    e1 = normalize(cross(up, w_hat))
    e2 = cross(w_hat, e1)
    phi = phi[..., None]
    return (torch.cos(alpha) * w_hat
            + torch.sin(alpha) * (torch.cos(phi) * e1 + torch.sin(phi) * e2))


def screen_coords(omega, width: int, height: int):
    """Image coordinates (u, v) [..., 2] in [0,1]² of the rays through the
    directions ``omega`` [..., 3] (the inverse of ``smallpt_camera_ray``),
    and the ray scale s [...] (s <= 0: behind the camera)."""
    _, cam_d, cx, cy = camera_frame(width, height, omega.device)
    # Solve a·cx + b·cy − s·ω = −cam_d.
    a_mat = torch.stack([cx.expand_as(omega), cy.expand_as(omega), -omega],
                        dim=-1)                                 # [..., 3, 3]
    abs_ = torch.linalg.solve(a_mat, (-cam_d).expand_as(omega))
    a, b, s = abs_[..., 0], abs_[..., 1], abs_[..., 2]
    return torch.stack([a + 0.5, b + 0.5], dim=-1), s


def first_hit_emission(scene: SphereScene, origin, direction):
    """Channel-mean emission of the first hit (the purely boundary-driven
    radiance of the validation tests)."""
    _, idx, hit = intersect_spheres(scene, origin, direction)
    e = torch.mean(scene.emission[torch.clamp_min(idx, 0).long()], dim=-1)
    return torch.where(hit, e, 0.0)


def direct_emission_image(scene: SphereScene, width: int, height: int,
                          samples_per_pixel: int = 4):
    """Deterministic mean of first-hit emission over the image square on a
    stratified sub-pixel grid (the forward function whose central
    differences the edge gradients are held to) → scalar."""
    n = samples_per_pixel
    device = scene.position.device
    u = (torch.arange(width * n, dtype=torch.float32, device=device)
         + 0.5) / (width * n)
    v = (torch.arange(height * n, dtype=torch.float32, device=device)
         + 0.5) / (height * n)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    o, d = smallpt_camera_ray(uu.reshape(-1), vv.reshape(-1), width, height)
    return torch.mean(first_hit_emission(scene, o, d))


def edge_position_gradient(scene: SphereScene, sphere_index: int,
                           width: int, height: int, n_samples: int = 512,
                           edge_eps: float = 1e-3,
                           radiance_fn=first_hit_emission):
    """Boundary term of d(mean channel-mean image)/d(center of sphere
    ``sphere_index``) → [3].

    ``radiance_fn(scene, origin, direction) -> [...]`` evaluates the
    channel-mean radiance along probe rays; the default covers
    emission-only renders (primary silhouettes only).
    """
    device = scene.position.device
    cam_o = camera_frame(width, height, device)[0]
    center = scene.position[sphere_index].detach()
    radius = scene.radius[sphere_index].detach()
    phis = (torch.arange(n_samples, dtype=torch.float32, device=device)
            + 0.5) * (2.0 * math.pi / n_samples)

    def q_of(phi, c):
        return screen_coords(silhouette_direction(c, radius, cam_o, phi),
                             width, height)

    # Edge tangent and velocity by forward mode, every sample at once.
    (q, s), (dq_dphi, _) = jvp(lambda p: q_of(p, center), (phis,),
                               (torch.ones_like(phis),))
    dq_dc = torch.stack([
        jvp(lambda c: q_of(phis, c)[0], (center,), (axis,))[1]
        for axis in torch.eye(3, device=device)], dim=-1)       # [n, 2, 3]

    # Radiance just inside and outside the silhouette. Probe origins follow
    # the camera's convention (pinhole + 140·d, d = s·ω: smallpt starts its
    # rays inside the box, past the front wall sphere).
    probe_o = cam_o + 140.0 * s[:, None] * silhouette_direction(
        center, radius, cam_o, phis)
    l_in = radiance_fn(scene, probe_o, silhouette_direction(
        center, radius, cam_o, phis, -edge_eps))
    l_out = radiance_fn(scene, probe_o, silhouette_direction(
        center, radius, cam_o, phis, +edge_eps))

    inside_image = (s > 0.0) & torch.all((q >= 0.0) & (q <= 1.0), dim=-1)
    # det[∂q/∂φ, ∂q/∂c_j]: signed image area swept per unit c_j.
    det = (dq_dphi[:, 0, None] * dq_dc[:, 1, :]
           - dq_dphi[:, 1, None] * dq_dc[:, 0, :])              # [n, 3]
    contributions = torch.where(inside_image[:, None],
                                (l_in - l_out)[:, None] * det, 0.0)
    # Mean over φ times the 2π measure of the parameterization.
    return torch.mean(contributions, dim=0) * (2.0 * math.pi)


def smallpt_position_gradient(scene: SphereScene, sphere_index: int,
                              width: int, height: int, forward_fn,
                              n_samples: int = 512,
                              radiance_fn=first_hit_emission):
    """Pathwise (autograd of ``forward_fn``) plus primary-silhouette
    boundary gradient of a scalar image functional with respect to one
    sphere's center → [3].

    ``forward_fn(scene) -> scalar`` must be the mean over the image square
    of the radiance ``radiance_fn`` probes along edge rays.
    """
    center = scene.position[sphere_index].detach().clone().requires_grad_()
    rows = torch.arange(scene.position.shape[0],
                        device=scene.position.device)[:, None]
    position = torch.where(rows == sphere_index, center,
                           scene.position.detach())
    value = forward_fn(scene._replace(position=position))
    # A forward that only sees visibility (first-hit emission) does not
    # depend on the center at all: its pathwise term is zero.
    pathwise = (torch.autograd.grad(value, center, allow_unused=True,
                                    materialize_grads=True)[0]
                if value.requires_grad else torch.zeros_like(center))
    boundary = edge_position_gradient(scene, sphere_index, width, height,
                                      n_samples=n_samples,
                                      radiance_fn=radiance_fn)
    return pathwise + boundary
