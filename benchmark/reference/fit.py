"""Plain PyTorch reference of the inverse-rendering fit.

Frozen from ``bifrost3d_tpu_torch`` at commit 9b83bae: the wavefront
iteration of ``integrator/path_tracer._wavefront_step`` (with its
``_intersect_analytic_lights``, the attribute interpolation and the
NEAREST texture path of ``_surface_material_params``) over the reference's
own tables, and the Adam loop of ``diff/render_grad.optimize_materials``.
Autograd flows from the image to the material tints and roughnesses; the
scene queries are detached, as the program's are (the hit query is a
sampler), and run as the plain brute-force trace of ``render.py``.

It takes the scenes ``render.check_supported`` takes, without path
regularization, trilinear textures or coverage-aware shadows.
"""

from __future__ import annotations

import torch

from benchmark.reference import render as ref
from benchmark.reference.frozen.lights.analytic import (
    _ray_sphere_t,
    evaluate_light,
    light_pdf,
)
from benchmark.reference.frozen.lights.types import LIGHT_SPHERE, LIGHT_SPOT
from benchmark.reference.frozen.math.clip import maximum, minimum
from benchmark.reference.frozen.math.ray_offset import offset_ray_origin
from benchmark.reference.frozen.math.vec import (
    cross,
    dot,
    normalize,
    reflect,
    to_local,
    to_world,
)
from benchmark.reference.frozen.sampling.sobol import Dimension, path_rng_4d


def _intersect_analytic_lights(tables: ref.Tables, origin, direction):
    """Nearest sphere-light or spot-disk hit → (t [r], light index [r])."""
    r = origin.shape[0]
    lights = tables.light_array
    if lights.count == 0:
        return (torch.full((r,), float("inf"), device=origin.device),
                torch.full((r,), -1, dtype=torch.int32, device=origin.device))
    is_sphere = lights.kind == LIGHT_SPHERE
    is_spot = lights.kind == LIGHT_SPOT
    pos = lights.position[None, :, :]
    radius = lights.radius[None, :]
    o = origin[:, None, :]
    d = direction[:, None, :]
    t_sphere = _ray_sphere_t(o, d, pos, radius)
    ldir = lights.direction[None, :, :]
    denom = dot(d, ldir)
    t_disk = dot(pos - o, ldir) / torch.where(torch.abs(denom) > 1e-9,
                                               denom, 1e-9)
    off = o + d * t_disk[..., None] - pos
    on_disk = torch.sum(off * off, dim=-1) <= radius * radius
    t_disk = torch.where(on_disk & (torch.abs(denom) > 1e-9), t_disk, -1.0)
    t = torch.where(is_sphere[None, :], t_sphere,
                    torch.where(is_spot[None, :], t_disk, -1.0))
    t = torch.where((t > 0) & (radius > 0), t, float("inf"))
    t_min = torch.amin(t, dim=1)
    idx = torch.argmin(t, dim=1).to(torch.int32)
    return t_min, torch.where(torch.isfinite(t_min), idx, -1)


def _interpolate(bary, attr):
    """Σ_k bary[r, k] · attr[r, k, c]."""
    return torch.sum(bary[..., None] * attr, dim=1)


def _detached_hit(tables: ref.Tables, origin, direction, live, t_max=None):
    with torch.no_grad():
        t, prim, u, v = ref.closest_hit(tables, origin.detach(),
                                        direction.detach(), live,
                                        None if t_max is None
                                        else t_max.detach())
    return torch.where(prim >= 0, t, float("inf")), prim, u, v


def frame(tables: ref.Tables, settings: ref.Settings, cam, width: int,
          height: int, accumulation: int, tint, roughness):
    """One progressive frame of the wavefront estimator → radiance [h, w,
    3], differentiable in the material ``tint`` [m, 3] and ``roughness``
    [m]."""
    device = tint.device
    y, x = torch.meshgrid(torch.arange(height, device=device),
                          torch.arange(width, device=device), indexing="ij")
    x, y = x.reshape(-1), y.reshape(-1)
    acc = torch.full_like(x, int(accumulation))
    origin, direction, pixel_hash = ref.camera_lanes(cam, x, y, width, height,
                                                     acc)
    p = x.shape[0]
    throughput = torch.ones((p, 3), device=device)
    radiance = torch.zeros((p, 3), device=device)
    bsdf_pdf = torch.zeros(p, device=device)
    bounce = torch.zeros(p, dtype=torch.int64, device=device)
    active = torch.isfinite(origin[..., 0])
    textured = any(tr >= 0 for tr in tables.mat_tex)
    mats = tables.mats
    for _ in range(settings.n_iters):
        hit_t, prim, hu, hv = _detached_hit(tables, origin, direction, active)
        hit_mask = prim >= 0
        t_light, light_idx = _intersect_analytic_lights(tables, origin,
                                                        direction)
        light_first = t_light < hit_t
        mesh_hit = active & hit_mask & ~light_first
        light_hit = active & light_first
        miss = active & ~hit_mask & ~light_first
        radiance = radiance + torch.where(
            miss[..., None], throughput * tables.background, 0.0)
        if tables.light_array.count > 0:
            li = torch.clamp_min(light_idx, 0)
            l_radiance = evaluate_light(tables.light_array, li, origin,
                                        direction)
            l_pdf = light_pdf(tables.light_array, li, origin, direction)
            w = torch.where(bsdf_pdf > 0.0, ref.mis_weight(bsdf_pdf, l_pdf),
                            1.0)
            clamped_t = minimum(throughput, settings.firefly_clamp)
            radiance = radiance + torch.where(
                light_hit[..., None], clamped_t * l_radiance * w[..., None],
                0.0)

        pr = torch.clamp_min(prim, 0)
        v = tables.verts[pr]
        a = tables.attr[:, pr]
        bary = torch.stack([1.0 - hu - hv, hu, hv], dim=-1)
        position = _interpolate(bary, v)
        n = torch.stack([a[0:3].T, a[3:6].T, a[6:9].T], dim=1)
        shading_normal = normalize(_interpolate(bary, n))
        geo_normal = normalize(cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]))
        mat_idx = a[9].long()
        m = mats[mat_idx]
        m_tint = tint[mat_idx]
        m_rough = roughness[mat_idx]
        if textured:
            uv = _interpolate(bary, torch.stack([
                torch.stack([a[13], a[16]], dim=-1),
                torch.stack([a[14], a[17]], dim=-1),
                torch.stack([a[15], a[18]], dim=-1)], dim=1))
            tex = torch.ones((p, 4), device=device)
            for k, tr_tex in enumerate(tables.mat_tex):
                if tr_tex >= 0:
                    tex = torch.where(
                        (mat_idx == k)[:, None],
                        ref._tex_fetch_nearest(tables.texels,
                                               tables.tex_meta[tr_tex],
                                               uv[:, 0], uv[:, 1]), tex)
            m_tint = m_tint * tex[:, 0:3]
            m_rough = m_rough * tex[:, 3]
        thin_walled = m[:, 6] > 0.5
        hit_from_front = dot(geo_normal, direction) < 0.0
        backside_cull = ~hit_from_front & ~thin_walled
        u_bsdf4 = path_rng_4d(accumulation, pixel_hash,
                              bounce * Dimension.PER_BOUNCE + Dimension.BSDF)
        passthrough = mesh_hit & backside_cull
        shade = mesh_hit & ~backside_cull

        front = hit_from_front[..., None]
        geo_normal = torch.where(front, geo_normal, -geo_normal)
        sn = torch.where(front, shading_normal, -shading_normal)
        sn = ref._fix_backfacing_shading_normal(-direction, sn)
        wo = to_local(-direction, sn)
        cos_theta_o = torch.where(hit_from_front | thin_walled, wo[..., 2],
                                  -wo[..., 2])
        coat = m[:, 11] if tables.has_coat else torch.zeros_like(m[:, 11])
        coat_r = m[:, 12] if tables.has_coat else torch.zeros_like(m[:, 12])
        shading = ref._create_shading(m_tint, m_rough, m[:, 4], m[:, 5], coat,
                                      coat_r, cos_theta_o)
        radiance = radiance + torch.where(shade[..., None],
                                          throughput * m[:, 7:10], 0.0)

        u_nee = path_rng_4d(accumulation, pixel_hash,
                            bounce * Dimension.PER_BOUNCE + Dimension.NEE)
        l_dir, l_dist, l_radiance, nee_valid = ref._reestimated_light_samples(
            tables.light_array, shading, position, wo, sn, u_nee,
            settings.ris_count, settings.delta_light_clamp)
        l_radiance = l_radiance * throughput
        shadow_side = torch.where(dot(l_dir, geo_normal) >= 0, 1.0, -1.0)
        shadow_origin = offset_ray_origin(position,
                                          geo_normal * shadow_side[..., None])
        has_light = shade & (torch.amax(l_radiance, dim=-1) > 0.0)
        _, s_prim, _, _ = _detached_hit(tables, shadow_origin, l_dir,
                                        has_light, l_dist * (1.0 - 1e-4))
        shadow_trans = torch.where(s_prim >= 0, 0.0, 1.0)
        radiance = radiance + torch.where(
            has_light[..., None], l_radiance * shadow_trans[..., None], 0.0)

        s = shading.sample(wo, u_bsdf4[..., :3])
        new_dir = to_world(s.direction, sn)
        is_reflection = s.direction[..., 2] >= 0.0
        cos_geo = dot(new_dir, geo_normal)
        wrong_side = torch.where(is_reflection, cos_geo < 0.0, cos_geo >= 0.0)
        new_dir = torch.where(wrong_side[..., None],
                              reflect(new_dir, geo_normal), new_dir)
        weight = torch.abs(s.direction[..., 2]) / maximum(s.pdf, 1e-12)
        new_throughput = torch.where(
            (s.pdf > 0.0)[..., None],
            throughput * s.reflectance * weight[..., None], 0.0)
        bounce_side = torch.where(dot(new_dir, geo_normal) >= 0, 1.0, -1.0)
        new_origin = offset_ray_origin(position,
                                       geo_normal * bounce_side[..., None])
        new_bsdf_pdf = torch.where(s.is_delta | ~nee_valid, 0.0, s.pdf)
        pass_origin = offset_ray_origin(position, -geo_normal)

        shade_c = shade[..., None]
        origin = torch.where(shade_c, new_origin,
                             torch.where(passthrough[..., None], pass_origin,
                                         origin))
        direction = torch.where(shade_c, new_dir, direction)
        throughput = torch.where(shade_c, new_throughput, throughput)
        bsdf_pdf = torch.where(shade, new_bsdf_pdf, bsdf_pdf)
        bounce = torch.where(shade, bounce + 1, bounce)
        active = (active & ~miss & ~light_hit
                  & (~shade | (torch.amax(throughput, dim=-1) > 0.0))
                  & (bounce <= settings.max_bounce))
    return radiance.reshape(height, width, 3)


def optimize(tables: ref.Tables, settings: ref.Settings, cam, target,
             width: int, height: int, steps: int, tint, roughness,
             learning_rate: float = 5e-2, dtype=torch.float32):
    """``optimize_materials`` with ``spp`` 1 and fresh samples each step:
    Adam over the tints and roughnesses from ``tint`` / ``roughness``,
    clamped to [0, 1] and [0.02, 1] after each step → (losses, the
    gradient of the first step (tint, roughness), tint, roughness, each
    step's frame).
    ``dtype`` below float32 holds the parameters and each frame in it
    (the control)."""
    tint = tint.detach().clone().requires_grad_()
    roughness = roughness.detach().clone().requires_grad_()
    opt = torch.optim.Adam([tint, roughness], lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    losses, first_grad, frames = [], None, []
    def held(x):
        # The value rounded to ``dtype``, the gradient passed through.
        return x + (x.detach().to(dtype).to(torch.float32) - x.detach())

    for step in range(steps):
        img = held(frame(tables, settings, cam, width, height, step,
                         held(tint), held(roughness)))
        frames.append(img.detach())
        loss = torch.mean(torch.square(img - target))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if first_grad is None:
            first_grad = (tint.grad.detach().clone(),
                          roughness.grad.detach().clone())
        opt.step()
        with torch.no_grad():
            tint.clamp_(0.0, 1.0)
            roughness.clamp_(0.02, 1.0)
        losses.append(float(loss.detach()))
    return losses, first_grad, tint.detach(), roughness.detach(), frames
