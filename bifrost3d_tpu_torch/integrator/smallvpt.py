"""smallvpt: the volumetric SmallPT variant (homogeneous scattering medium).

Port of ``bifrost3d_tpu/integrator/smallvpt.py`` (``_medium_near_t``,
``_interaction``, ``render_smallvpt_accumulation``, ``render_smallvpt``):
the Cornell sphere scene wrapped in a big homogeneous medium sphere
(σ_t = 0.01), exponential free-flight sampling, absorption Russian roulette
on the single-scattering albedo and Henyey-Greenstein phase sampling with
g = -0.5, as masked wavefront lanes. Plain torch: the JAX package has no
kernel for it either.

- Depth counts interactions (surface and scattering events).
- Glass uses pure Fresnel Russian roulette (smallvpt.h:150-158), without
  smallpt's 0.25 + 0.5·Re reweighting.
- The medium roulette does not divide by the survival probability
  (reference behaviour: throughput *= albedo, survive with P = avg(albedo)).
"""

from __future__ import annotations

import numpy as np
import torch

from bifrost3d_tpu_torch.integrator.smallpt import (
    EPS,
    ORIGIN_OFFSET,
    _diffuse_dir,
    _initial_lane_state,
    pixel_grid,
)
from bifrost3d_tpu_torch.math.vec import dot, normalize, reflect, to_world
from bifrost3d_tpu_torch.sampling.distributions import henyey_greenstein_sample
from bifrost3d_tpu_torch.sampling.hashes import lcg_next
from bifrost3d_tpu_torch.scene.spheres import SphereScene, intersect_spheres

MEDIUM_CENTER = (50.0, 50.0, 80.0)
MEDIUM_RADIUS = 300.0
SIGMA_T = 0.01
MEDIUM_ALBEDO = (0.9, 0.6, 0.3)
HG_G = -0.5
MAX_INTERACTIONS = 32
_MEAN_ALBEDO = float(np.mean(np.asarray(MEDIUM_ALBEDO, np.float32)))
_INF = float("inf")


def _medium_near_t(origin, direction):
    """Entry distance into the medium sphere (0 when inside), inf on a
    miss (smallvpt.h Sphere::intersect tin/tout semantics)."""
    op = origin.new_tensor(MEDIUM_CENTER) - origin
    b = dot(op, direction)
    det = MEDIUM_RADIUS * MEDIUM_RADIUS - (dot(op, op) - b * b)
    sqrt_det = torch.sqrt(torch.clamp_min(det, 0.0))
    t_in = torch.clamp_min(b - sqrt_det, 0.0)
    hits = (det >= 0.0) & (b + sqrt_det > 0.0)
    return torch.where(hits, t_in, _INF)


def _interaction(scene: SphereScene, state):
    origin, direction, throughput, radiance, rng, live, depth = state
    medium_albedo = origin.new_tensor(MEDIUM_ALBEDO)

    # Free-flight sampling through the medium (smallvpt.h:79-83).
    t_medium = _medium_near_t(origin, direction)
    rng_m, u_m = lcg_next(rng)
    rng = torch.where(live & torch.isfinite(t_medium), rng_m, rng)
    flight = -torch.log(torch.clamp_min(1.0 - u_m, 1e-12)) / SIGMA_T
    scatter_t = torch.where(torch.isfinite(t_medium), t_medium + flight, _INF)

    t_surf, idx, hit_surf = intersect_spheres(scene, origin, direction, eps=EPS)
    idx = torch.clamp_min(idx, 0).long()

    scatters = live & (scatter_t <= t_surf)
    hits = live & ~scatters & hit_surf
    live = live & (scatters | hits)

    # Scattering event (smallvpt.h:92-105).
    rng_rr, u_rr = lcg_next(rng)
    rng_h1, u_h1 = lcg_next(rng_rr)
    rng_h2, u_h2 = lcg_next(rng_h1)
    absorb = u_rr >= _MEAN_ALBEDO
    hg_local, _ = henyey_greenstein_sample(
        HG_G, torch.stack([u_h1, u_h2], dim=-1))
    scatter_dir = normalize(to_world(hg_local, direction))
    scatter_pos = origin + direction * scatter_t[..., None]

    # Surface interaction (smallvpt.h:108-160).
    pos = origin + direction * t_surf[..., None]
    norm = normalize(pos - scene.position[idx])
    nl = torch.where(dot(norm, direction)[..., None] < 0.0, norm, -norm)
    albedo = scene.color[idx]
    emission = scene.emission[idx]
    radiance = radiance + torch.where(hits[..., None], throughput * emission,
                                      0.0)

    # Surface roulette after 5 interactions.
    rr_on = depth + 1 > 5
    rng_s, u_s = lcg_next(rng)
    max_albedo = torch.amax(albedo, dim=-1)
    survive = torch.where(rr_on, u_s < max_albedo, True)
    albedo = torch.where(
        rr_on[..., None],
        albedo / torch.clamp_min(max_albedo, 1e-6)[..., None], albedo)

    bsdf = scene.bsdf[idx]
    is_dif = hits & (bsdf == 0)
    is_gls = hits & (bsdf == 2)

    rng_d1, u1 = lcg_next(torch.where(rr_on, rng_s, rng))
    rng_d2, u2 = lcg_next(rng_d1)
    dir_dif = _diffuse_dir(nl, u1, u2)
    dir_mir = reflect(direction, norm)

    into = dot(norm, nl) > 0.0
    rel_ior = torch.where(into, 1.0 / 1.5, 1.5)
    ddn = dot(direction, nl)
    cos2t = 1.0 - rel_ior * rel_ior * (1.0 - ddn * ddn)
    tir = cos2t < 0.0
    tdir = normalize(
        direction * rel_ior[..., None]
        - norm * (torch.where(into, 1.0, -1.0)
                  * (ddn * rel_ior
                     + torch.sqrt(torch.clamp_min(cos2t, 0.0))))[..., None])
    spec = ((1.5 - 1.0) / (1.5 + 1.0)) ** 2
    cos_theta = torch.where(into, -ddn, dot(norm, tdir))
    c = 1.0 - cos_theta
    c2 = c * c
    re = spec + (1.0 - spec) * (c2 * c2 * c)
    rng_g, u_g = lcg_next(torch.where(
        is_dif, rng_d2, torch.where(rr_on, rng_s, rng)))
    pick_refl = u_g < re
    dir_gls = torch.where((tir | pick_refl)[..., None], dir_mir, tdir)
    # Glass: reflection keeps the throughput, refraction picks up the albedo
    # (smallvpt.h:156-159); total internal reflection draws no sample.
    gls_weight = torch.where((tir | pick_refl)[..., None],
                             torch.ones_like(albedo), albedo)

    # Advance each lane's RNG by what it consumed.
    rng_after_rr = torch.where(rr_on & hits, rng_s, rng)
    rng = torch.where(scatters, rng_h2,
                      torch.where(is_dif, rng_d2,
                                  torch.where(is_gls & ~tir, rng_g,
                                              rng_after_rr)))

    surf_dir = torch.where(is_dif[..., None], dir_dif,
                           torch.where(is_gls[..., None], dir_gls, dir_mir))
    # Diffuse and mirror scale by the albedo; glass by its picked weight.
    surf_weight = torch.where(is_gls[..., None], gls_weight, albedo)

    new_origin = torch.where(
        scatters[..., None], scatter_pos,
        pos + norm * torch.sign(dot(surf_dir, norm))[..., None] * ORIGIN_OFFSET)
    new_dir = torch.where(scatters[..., None], scatter_dir, surf_dir)
    new_throughput = torch.where(
        scatters[..., None], throughput * medium_albedo,
        torch.where(hits[..., None], throughput * surf_weight, throughput))

    live = live & torch.where(scatters, ~absorb, survive)
    live = live & (torch.amax(new_throughput, dim=-1) > 1e-6)
    depth = torch.where(scatters | hits, depth + 1, depth)
    return (new_origin, new_dir, new_throughput, radiance, rng, live, depth)


def render_smallvpt_accumulation(scene: SphereScene, width: int, height: int,
                                 accumulation: int):
    """One progressive volumetric sample per pixel → [height, width, 3]."""
    x, y = pixel_grid(width, height, scene.position.device)
    origin, direction, throughput, radiance, rng, live = _initial_lane_state(
        x, y, width, height, accumulation)
    state = (origin, direction, throughput, radiance, rng, live,
             torch.zeros(origin.shape[:-1], dtype=torch.int64,
                         device=origin.device))
    for _ in range(MAX_INTERACTIONS):
        state = _interaction(scene, state)
    return state[3]


def render_smallvpt(scene: SphereScene, width: int, height: int,
                    accumulations: int):
    buffer = torch.zeros((height, width, 3), device=scene.position.device)
    for n in range(1, accumulations + 1):
        frame = render_smallvpt_accumulation(scene, width, height, n)
        buffer = buffer + (frame - buffer) / n
    return buffer
