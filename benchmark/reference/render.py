"""Plain PyTorch reference of a progressive mesh render and its post.

Frozen from ``bifrost3d_tpu_torch`` at commit 9b83bae: the iteration of
``integrator/pallas_mesh.mesh_megakernel_reference`` (the megakernel's
plain version), with ``_analytic_light_hits`` and ``_tex_fetch_nearest``
from the same file and ``mis_weight``, ``_fix_backfacing_shading_normal``,
``_create_shading``, ``_sample_single_light``,
``_reestimated_light_samples``, ``_reverse_halton_offsets`` and
``_camera_lanes`` from ``integrator/path_tracer.py``; the trace is a plain
brute-force Möller–Trumbore over the whole soup
(``geometry/pallas_intersect._mt_block``), which finds the same closest hit
as any culled or hierarchical trace. The modules under ``frozen/`` are
copies of the port's, their imports pointed here. Nothing here imports the
port: the scene tables are worked out again from the configuration's raw
data (``reference/scene.py``).

The scenes it takes are those of the benchmark's configurations: the
Default shading model, sphere, spot and directional lights, the background
tint (no environment map), NEAREST tint-roughness textures, one binary
any-hit shadow ray. ``check_supported`` refuses anything else.

Lanes are independent, so a lane is a (pixel, accumulation) pair: a sample
of pixels renders all its accumulations at once, and the running mean over
them is the program's ``render_progressive`` lerp, in the same order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import scene as scene_mod
from benchmark.reference.frozen.lights.analytic import (
    evaluate_light,
    light_pdf,
    sample_light,
)
from benchmark.reference.frozen.lights.types import (
    LIGHT_SPHERE,
    LIGHT_SPOT,
    LightArray,
)
from benchmark.reference.frozen.math.clip import maximum, minimum
from benchmark.reference.frozen.math.ray_offset import offset_ray_origin
from benchmark.reference.frozen.math.vec import (
    dot,
    gsafe,
    normalize,
    reflect,
    to_local,
    to_world,
)
from benchmark.reference.frozen.post.pipeline import process
from benchmark.reference.frozen.post.tonemap import CameraEffectsSettings
from benchmark.reference.frozen.sampling.hashes import pcg2d
from benchmark.reference.frozen.sampling.sobol import Dimension, path_rng_4d
from benchmark.reference.frozen.scene.camera import (
    camera_ray_directions,
    perspective_camera,
)
from benchmark.reference.frozen.shading.default_shading import DefaultShading

_BIG = 3.0e38
_EPS_DET = 1e-9
ATTR_ROWS = 24
TONEMAPPERS = ("linear", "filmic", "agx", "khronos")
WRAP_REPEAT = 1
# Ray-triangle pairs a block of the brute-force trace holds at once.
_PAIRS_PER_BLOCK = 1 << 24
_TRI_CHUNK = 512


class Settings(NamedTuple):
    """What a frame's estimator reads of ``RenderSettings``."""

    max_bounce: int = 4
    ris_count: int = 3
    firefly_clamp: float = 4.0
    delta_light_clamp: float = 32.0
    passthrough_slack: int = 2

    @property
    def n_iters(self) -> int:
        return self.max_bounce + 1 + self.passthrough_slack


class Tables(NamedTuple):
    """The reference's own scene tables on one device."""

    tri: torch.Tensor          # [t, 9] v0, e1, e2
    verts: torch.Tensor        # [t, 3, 3] the soup's corners
    attr: torch.Tensor         # [24, t] corner normals 0-8, material 9,
    #                            geometric normal 10-12, corner uvs 13-18
    mats: torch.Tensor         # [m, 16] (scene.material_rows)
    lights: torch.Tensor       # [n, 12] position, radius, power, direction,
    #                            cos_angle
    light_kinds: tuple
    light_array: LightArray
    texels: torch.Tensor       # [N, 4] level 0 of every texture
    tex_meta: tuple            # per texture (first texel, w, h, wrap, wrap)
    mat_tex: tuple             # per material its tint-roughness texture
    epsilon: float
    background: torch.Tensor   # [3]
    has_coat: bool
    n_tris: int


def check_supported(raw: scene_mod.RawScene) -> None:
    for i, m in enumerate(raw.materials):
        given = dict(scene_mod.MATERIAL_DEFAULTS, **m)
        if given["shading_model"] != 0 or given["coverage"] < 1.0 \
                or given["coverage_texture"] >= 0 or given["flags"] & 2 \
                or any(given["emission"]):
            raise ValueError(f"material {i}: the reference takes opaque, "
                             "non-emissive Default materials only")
    for t in raw.textures:
        if t["filter"] != 0:
            raise ValueError("the reference fetches NEAREST textures only")


def build_tables(raw: scene_mod.RawScene, device) -> Tables:
    check_supported(raw)
    verts, normals, uvs, mat_ids = scene_mod.soup(raw)
    t = verts.shape[0]
    tv = torch.tensor(verts, device=device)
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    geo_n = torch.linalg.cross(e1, e2, dim=-1)
    geo_n = geo_n / torch.clamp_min(
        torch.linalg.vector_norm(geo_n, dim=-1, keepdim=True), 1e-20)
    n = torch.tensor(normals, device=device)
    n = n / torch.clamp_min(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                            1e-20)
    uv = torch.tensor(uvs, device=device)
    attr = torch.zeros((ATTR_ROWS, t), dtype=torch.float32, device=device)
    attr[0:9] = n.reshape(t, 9).T
    attr[9] = torch.tensor(mat_ids, device=device).to(torch.float32)
    attr[10:13] = geo_n.T
    attr[13:16] = uv[:, :, 0].T
    attr[16:19] = uv[:, :, 1].T
    tri = torch.cat([tv[:, 0], e1, e2], dim=1).contiguous()

    mats = torch.tensor(scene_mod.material_rows(raw), device=device)
    kinds, rows = [], []
    for li in raw.lights:
        d = np.asarray(li.get("direction", (0, 0, 1)), np.float32)
        d = d / max(np.linalg.norm(d), 1e-20)
        row = np.zeros(12, np.float32)
        row[0:3] = li.get("position", (0, 0, 0))
        row[3] = li.get("radius", 0.0)
        row[4:7] = li.get("power", li.get("radiance", (0, 0, 0)))
        row[7:10] = d
        row[10] = li.get("cos_angle", 0.0)
        kinds.append(int(li["kind"]))
        rows.append(row)
    lights = torch.tensor(np.asarray(rows, np.float32).reshape(-1, 12),
                          device=device)
    light_array = LightArray(
        kind=torch.tensor(kinds, dtype=torch.int32, device=device),
        position=lights[:, 0:3], radius=lights[:, 3], power=lights[:, 4:7],
        direction=lights[:, 7:10], cos_angle=lights[:, 10])

    blocks, metas, base = [], [], 0
    for tex in raw.textures:
        img = np.asarray(tex["image"], np.float32)
        h, w = img.shape[0], img.shape[1]
        rgba = np.ones((h, w, 4), np.float32)
        rgba[..., :img.shape[-1]] = img
        blocks.append(rgba.reshape(h * w, 4))
        metas.append((base, w, h, tex.get("wrap_u", WRAP_REPEAT),
                      tex.get("wrap_v", WRAP_REPEAT)))
        base += h * w
    texels = torch.tensor(np.concatenate(blocks) if blocks
                          else np.zeros((1, 4), np.float32), device=device)
    mat_tex = tuple(int(dict(scene_mod.MATERIAL_DEFAULTS, **m)
                        ["tint_roughness_texture"]) for m in raw.materials)
    return Tables(
        tri=tri, verts=tv, attr=attr, mats=mats, lights=lights,
        light_kinds=tuple(kinds), light_array=light_array, texels=texels,
        tex_meta=tuple(metas), mat_tex=mat_tex,
        epsilon=scene_mod.scene_epsilon(verts),
        background=torch.tensor(raw.environment_tint, dtype=torch.float32,
                                device=device),
        has_coat=bool(any(dict(scene_mod.MATERIAL_DEFAULTS, **m)["coat"] > 0
                          for m in raw.materials)),
        n_tris=t)


# -- camera lanes ---------------------------------------------------------------

def camera(pose: dict, width: int, height: int, device):
    return perspective_camera(eye=tuple(pose["eye"]),
                              target=tuple(pose["target"]),
                              fov_radians=pose["fov_radians"],
                              aspect=width / height, device=device)


def camera_lanes(cam, x, y, width: int, height: int, accumulation):
    """Lanes of int64 pixels x, y [p] at int64 ``accumulation`` [p] →
    (origin, direction, pixel_hash), as ``path_tracer._camera_lanes``."""
    pixel_hash, _ = pcg2d(x, y)
    u_cam = path_rng_4d(accumulation, pixel_hash, Dimension.CAMERA)
    first = accumulation == 0
    xf = x.to(torch.float32) + torch.where(first, 0.5, u_cam[..., 0])
    yf = y.to(torch.float32) + torch.where(first, 0.5, u_cam[..., 1])
    origin, direction = camera_ray_directions(
        cam, torch.stack([xf / width, 1.0 - yf / height], dim=-1))
    return origin, direction, pixel_hash


# -- the trace --------------------------------------------------------------------

def _mt_block(o, d, tri, t_min):
    """Möller–Trumbore for [R, 1] rays × [1, T] triangles → [R, T]."""
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


def _trace_block(tri_t, n_tris, origin, direction, t_min, t_max):
    r = origin.shape[0]
    o = tuple(origin[:, c:c + 1] for c in range(3))
    d = tuple(direction[:, c:c + 1] for c in range(3))
    t_hi = t_max[:, None]
    best_t = torch.full((r,), _BIG, dtype=torch.float32, device=origin.device)
    best_prim = torch.full((r,), -1, dtype=torch.int64, device=origin.device)
    best_u = torch.zeros(r, dtype=torch.float32, device=origin.device)
    best_v = torch.zeros(r, dtype=torch.float32, device=origin.device)
    for start in range(0, n_tris, _TRI_CHUNK):
        stop = min(start + _TRI_CHUNK, n_tris)
        t, u, v, valid = _mt_block(o, d, tri_t[:, start:stop], t_min)
        valid = valid & (t < t_hi) & (t < best_t[:, None])
        t = torch.where(valid, t, _BIG)
        k = torch.argmin(t, dim=1, keepdim=True)
        t_new = torch.gather(t, 1, k)[:, 0]
        closer = t_new < best_t
        best_t = torch.where(closer, t_new, best_t)
        best_prim = torch.where(closer, k[:, 0] + start, best_prim)
        best_u = torch.where(closer, torch.gather(u, 1, k)[:, 0], best_u)
        best_v = torch.where(closer, torch.gather(v, 1, k)[:, 0], best_v)
    return best_t, best_prim, best_u, best_v


def closest_hit(tables: Tables, origin, direction, live, t_max=None):
    """Nearest triangle hit of the ``live`` lanes → (t, prim, u, v), prim
    -1 and t ``_BIG`` on a miss or an idle lane; only live lanes are
    traced, in blocks."""
    p = origin.shape[0]
    device = origin.device
    t_out = torch.full((p,), _BIG, dtype=torch.float32, device=device)
    prim = torch.full((p,), -1, dtype=torch.int64, device=device)
    u_out = torch.zeros(p, dtype=torch.float32, device=device)
    v_out = torch.zeros(p, dtype=torch.float32, device=device)
    idx = torch.nonzero(live).flatten()
    if idx.numel() == 0:
        return t_out, prim, u_out, v_out
    tri_t = tables.tri.T.contiguous()
    block = max(1, _PAIRS_PER_BLOCK // min(_TRI_CHUNK, tables.n_tris))
    for s in range(0, idx.numel(), block):
        sel = idx[s:s + block]
        hi = (torch.full((sel.numel(),), float("inf"), device=device)
              if t_max is None else t_max[sel])
        bt, bp, bu, bv = _trace_block(tri_t, tables.n_tris, origin[sel],
                                      direction[sel], tables.epsilon, hi)
        t_out[sel], prim[sel], u_out[sel], v_out[sel] = bt, bp, bu, bv
    return t_out, prim, u_out, v_out


# -- shading and light sampling --------------------------------------------------

def mis_weight(pdf1, pdf2):
    divisor = pdf1 + pdf2
    result = pdf1 / torch.where(divisor == 0.0, 1.0, divisor)
    invalid = torch.isinf(divisor) | torch.isnan(result)
    return torch.where(invalid, torch.where(pdf1 <= pdf2, 0.0, 1.0), result)


def _fix_backfacing_shading_normal(w, n, target_cos=0.002):
    cos_theta = dot(w, n, keepdims=True)
    fixed = normalize(n - (cos_theta - target_cos) * w)
    return torch.where(cos_theta < target_cos, fixed, n)


def _reverse_halton_offsets(count: int = 8) -> np.ndarray:
    def reverse_halton(p, i):
        h, f = 0.0, 1.0 / p
        fct = f
        while i > 0:
            digit = i % p
            h += (0 if digit == 0 else p - digit) * fct
            i //= p
            fct *= f
        return h

    return np.asarray([[reverse_halton(p, i) for p in (2, 3, 5, 7)]
                       for i in range(count)], np.float32)


def _create_shading(tint, roughness, specularity, metallic, coat,
                    coat_roughness, cos_theta_o) -> DefaultShading:
    return DefaultShading.create(
        tint=tint, roughness=maximum(roughness, 0.0), specularity=specularity,
        metallic=metallic, coat=coat,
        coat_roughness=maximum(coat_roughness, 0.0),
        abs_cos_theta_o=torch.abs(cos_theta_o))


def _sample_single_light(lights: LightArray, shading, position, wo,
                         shading_normal, u3, delta_light_clamp: float):
    total = lights.count
    if total == 0:
        z = torch.zeros(position.shape[:-1], device=position.device)
        return position, z, torch.zeros_like(position), z > 0.0
    pick = torch.clamp_max((u3[..., 2] * total).to(torch.int32), total - 1)
    ls = sample_light(lights, pick, position, u3[..., :2])
    radiance = ls.radiance * total
    n_dot_l = dot(shading_normal, ls.direction)
    safe_pdf = maximum(ls.pdf, 1e-12)
    radiance = radiance * (torch.abs(n_dot_l) / safe_pdf)[..., None]
    radiance = torch.where((ls.pdf > 0.0)[..., None], radiance, 0.0)
    wi = to_local(ls.direction, shading_normal)
    f, bsdf_pdf = shading.evaluate_with_pdf(wo, wi)
    weight = torch.where(ls.is_delta, 1.0, mis_weight(ls.pdf, bsdf_pdf))
    f = torch.where(ls.is_delta[..., None],
                    minimum(f, delta_light_clamp), f)
    radiance = radiance * weight[..., None] * f
    return ls.direction, ls.distance, radiance, ls.pdf > 1e-6


def _reestimated_light_samples(lights: LightArray, shading, position, wo,
                               shading_normal, u4_base, ris_count: int,
                               delta_light_clamp: float):
    direction = torch.zeros_like(position)
    distance = torch.zeros(position.shape[:-1], device=position.device)
    radiance = torch.zeros_like(position)
    pdf_valid = torch.zeros(position.shape[:-1], dtype=torch.bool,
                            device=position.device)
    if ris_count <= 0:
        return direction, distance, radiance, pdf_valid
    offsets = torch.as_tensor(_reverse_halton_offsets(8),
                              device=position.device)
    for s in range(ris_count):
        u4 = u4_base + offsets[s]
        u4 = u4 - torch.floor(u4)
        new_dir, new_dist, new_rad, new_valid = _sample_single_light(
            lights, shading, position, wo, shading_normal, u4[..., :3],
            delta_light_clamp)
        w_old = torch.sum(radiance, dim=-1)
        w_new = torch.sum(new_rad, dim=-1)
        any_w = w_old + w_new > 0.0
        p_new = w_new / torch.where(any_w, w_old + w_new, 1.0)
        take = u4[..., 3] < p_new
        direction = torch.where(take[..., None], new_dir, direction)
        distance = torch.where(take, new_dist, distance)
        pdf_valid = torch.where(take, new_valid, pdf_valid)
        denom = torch.where(take, p_new, 1.0 - p_new)
        denom = torch.where(any_w & (denom > 1e-20), denom, 1.0)
        radiance = torch.where(
            any_w[..., None],
            torch.where(take[..., None], new_rad, radiance) / denom[..., None],
            0.0)
    return direction, distance, radiance / ris_count, pdf_valid


def _analytic_light_hits(lights, light_kinds, o, d):
    t_light = torch.full(o.shape[:1], _BIG, dtype=torch.float32,
                         device=o.device)
    idx = torch.full(o.shape[:1], -1, dtype=torch.int32, device=o.device)
    for k, kind in enumerate(light_kinds):
        pos, radius, ldir = lights[k, 0:3], lights[k, 3], lights[k, 7:10]
        if kind == LIGHT_SPHERE:
            op = pos - o
            b = dot(op, d)
            det = radius * radius - (dot(op, op) - b * b)
            sqrt_det = torch.sqrt(gsafe(det))
            t = torch.where(b - sqrt_det > 0, b - sqrt_det, b + sqrt_det)
            tk = torch.where((det >= 0) & (t > 0) & (radius > 0), t, _BIG)
        elif kind == LIGHT_SPOT:
            denom = dot(d, ldir)
            t = (dot(pos, ldir) - dot(o, ldir)) / torch.where(
                torch.abs(denom) > 1e-9, denom, 1e-9)
            off = o + d * t[:, None] - pos
            on_disk = dot(off, off) <= radius * radius
            tk = torch.where(on_disk & (torch.abs(denom) > 1e-9) & (t > 0)
                             & (radius > 0), t, _BIG)
        else:
            continue
        closer = tk < t_light
        t_light = torch.where(closer, tk, t_light)
        idx = torch.where(closer, k, idx)
    return t_light, idx


def _tex_fetch_nearest(texels, meta, u, v):
    base, w, h, wrap_u, wrap_v = meta
    vv = 1.0 - v
    fu = u - torch.floor(u) if wrap_u == WRAP_REPEAT else \
        torch.clamp(u, 0.0, 1.0)
    fv = vv - torch.floor(vv) if wrap_v == WRAP_REPEAT else \
        torch.clamp(vv, 0.0, 1.0)
    x = torch.round(fu * w - 0.5).long()
    y = torch.round(fv * h - 0.5).long()
    x = torch.remainder(x, w) if wrap_u == WRAP_REPEAT else \
        torch.clamp(x, 0, w - 1)
    y = torch.remainder(y, h) if wrap_v == WRAP_REPEAT else \
        torch.clamp(y, 0, h - 1)
    return texels[base + y * w + x]


# -- the estimator ----------------------------------------------------------------

def radiance(tables: Tables, settings: Settings, origin, direction,
             pixel_hash, accumulation, counts=None):
    """One sample per lane → radiance [p, 3]. ``accumulation`` is an int64
    [p] tensor. A ``counts`` dict, if given, receives the work done:
    ``traces`` (closest-hit queries of live lanes), ``shadow_rays`` and
    ``shaded`` (iterations that shaded a hit)."""
    device = origin.device
    p = origin.shape[0]
    lights = tables.lights
    light_arr = tables.light_array
    hits_lights = any(k in (LIGHT_SPHERE, LIGHT_SPOT)
                      for k in tables.light_kinds)
    textured = any(tr >= 0 for tr in tables.mat_tex)
    o, d = origin, direction
    throughput = torch.ones((p, 3), dtype=torch.float32, device=device)
    rad = torch.zeros((p, 3), dtype=torch.float32, device=device)
    bsdf_pdf = torch.zeros(p, dtype=torch.float32, device=device)
    bounce = torch.zeros(p, dtype=torch.int64, device=device)
    act = torch.ones(p, dtype=torch.bool, device=device)

    def count(key, mask):
        if counts is not None:
            counts[key] = counts.get(key, 0) + int(mask.sum())

    for _ in range(settings.n_iters):
        live = act
        count("traces", live)
        t_hit, prim, hu, hv = closest_hit(tables, o, d, live)
        hit_mask = prim >= 0
        t_light, light_idx = _analytic_light_hits(lights, tables.light_kinds,
                                                  o, d)
        light_first = t_light < t_hit
        mesh_hit = live & hit_mask & ~light_first
        light_hit = live & light_first & (light_idx >= 0)
        miss = live & ~hit_mask & ~light_first
        rad = rad + torch.where(miss[:, None],
                                throughput * tables.background, 0.0)
        if hits_lights:
            li = torch.clamp_min(light_idx, 0)
            l_rad = evaluate_light(light_arr, li, o, d)
            l_pdf = light_pdf(light_arr, li, o, d)
            w = torch.where(bsdf_pdf > 0.0, mis_weight(bsdf_pdf, l_pdf), 1.0)
            clamped = torch.clamp_max(throughput, settings.firefly_clamp)
            rad = rad + torch.where(light_hit[:, None],
                                    clamped * l_rad * w[:, None], 0.0)

        a = tables.attr[:, torch.clamp_min(prim, 0)]
        bary0 = 1.0 - hu - hv
        shading_n = normalize(a[0:3].T * bary0[:, None] + a[3:6].T * hu[:, None]
                              + a[6:9].T * hv[:, None])
        geo_n = a[10:13].T
        position = o + d * torch.where(hit_mask, t_hit, 0.0)[:, None]
        m = tables.mats[a[9].long()]
        zero = torch.zeros_like(m[:, 11])
        coat = m[:, 11] if tables.has_coat else zero
        coat_r = m[:, 12] if tables.has_coat else zero
        thin_walled = m[:, 6] > 0.5
        m_tint, m_rough = m[:, 0:3], m[:, 3]
        if textured:
            u_uv = a[13] * bary0 + a[14] * hu + a[15] * hv
            v_uv = a[16] * bary0 + a[17] * hu + a[18] * hv
            tex = torch.ones((p, 4), dtype=torch.float32, device=device)
            for k, tr_tex in enumerate(tables.mat_tex):
                if tr_tex >= 0:
                    tex = torch.where(
                        (a[9] == k)[:, None],
                        _tex_fetch_nearest(tables.texels,
                                           tables.tex_meta[tr_tex], u_uv,
                                           v_uv), tex)
            m_tint, m_rough = m_tint * tex[:, 0:3], m_rough * tex[:, 3]

        u_bsdf = path_rng_4d(accumulation, pixel_hash,
                             bounce * Dimension.PER_BOUNCE + Dimension.BSDF)
        u_nee = path_rng_4d(accumulation, pixel_hash,
                            bounce * Dimension.PER_BOUNCE + Dimension.NEE)

        hit_from_front = dot(geo_n, d) < 0.0
        skip = ~hit_from_front & ~thin_walled
        passthrough = mesh_hit & skip
        shade = mesh_hit & ~skip
        count("shaded", shade)
        front = hit_from_front[:, None]
        gf = torch.where(front, geo_n, -geo_n)
        sn = _fix_backfacing_shading_normal(
            -d, torch.where(front, shading_n, -shading_n))
        wo = to_local(-d, sn)
        cos_theta_o = torch.where(hit_from_front | thin_walled, wo[:, 2],
                                  -wo[:, 2])
        shading = _create_shading(m_tint, m_rough, m[:, 4], m[:, 5], coat,
                                  coat_r, cos_theta_o)
        rad = rad + torch.where(shade[:, None], throughput * m[:, 7:10], 0.0)

        nee_valid = torch.zeros(p, dtype=torch.bool, device=device)
        if len(tables.light_kinds) > 0 and settings.ris_count > 0:
            l_dir, l_dist, l_rad, nee_valid = _reestimated_light_samples(
                light_arr, shading, position, wo, sn, u_nee,
                settings.ris_count, settings.delta_light_clamp)
            l_rad = l_rad * throughput
            side = torch.where(dot(l_dir, gf) >= 0.0, 1.0, -1.0)
            shadow_origin = offset_ray_origin(position, gf * side[:, None])
            has_light = shade & (torch.amax(l_rad, dim=-1) > 0.0)
            count("shadow_rays", has_light)
            t_shadow = l_dist * (1.0 - 1e-4)
            _, s_prim, _, _ = closest_hit(tables, shadow_origin, l_dir,
                                          has_light, t_shadow)
            trans = torch.where(s_prim >= 0, 0.0, 1.0)
            rad = rad + torch.where(has_light[:, None],
                                    l_rad * trans[:, None], 0.0)

        s = shading.sample(wo, u_bsdf[:, :3])
        new_dir = to_world(s.direction, sn)
        is_reflection = s.direction[:, 2] >= 0.0
        cos_geo = dot(new_dir, gf)
        wrong_side = torch.where(is_reflection, cos_geo < 0.0, cos_geo >= 0.0)
        new_dir = torch.where(wrong_side[:, None], reflect(new_dir, gf),
                              new_dir)
        weight = torch.abs(s.direction[:, 2]) / torch.clamp_min(s.pdf, 1e-12)
        new_t = torch.where((s.pdf > 0.0)[:, None],
                            throughput * s.reflectance * weight[:, None], 0.0)
        b_side = torch.where(dot(new_dir, gf) >= 0.0, 1.0, -1.0)
        new_origin = offset_ray_origin(position, gf * b_side[:, None])
        new_bsdf_pdf = torch.where(s.is_delta | ~nee_valid, 0.0, s.pdf)
        pass_origin = offset_ray_origin(position, -gf)

        shade_c = shade[:, None]
        o = torch.where(shade_c, new_origin,
                        torch.where(passthrough[:, None], pass_origin, o))
        d = torch.where(shade_c, new_dir, d)
        throughput = torch.where(shade_c, new_t, throughput)
        bsdf_pdf = torch.where(shade, new_bsdf_pdf, bsdf_pdf)
        bounce = torch.where(shade, bounce + 1, bounce)
        still = ~shade | (torch.amax(throughput, dim=-1) > 0.0)
        act = (live & ~miss & ~light_hit & still
               & (bounce <= settings.max_bounce))
    return rad


def render_pixels(tables: Tables, settings: Settings, cam, width: int,
                  height: int, pixels, accumulations: int,
                  dtype=torch.float32, lanes_per_call: int = 1 << 18,
                  counts=None):
    """The progressive running mean of ``accumulations`` samples at flat
    pixel indices ``pixels`` [n] → [n, 3] float32: each frame's sample
    lerped in as ``buffer + (frame - buffer) / (k + 1)``, with frames and
    buffer held in ``dtype`` (float32, as the configuration states; the
    control passes a lower precision)."""
    device = pixels.device
    n = pixels.numel()
    acc = torch.arange(accumulations, dtype=torch.int64, device=device)
    px = pixels.repeat(accumulations)
    ak = acc.repeat_interleave(n)
    frames = torch.empty((accumulations * n, 3), dtype=torch.float32,
                         device=device)
    for s in range(0, px.numel(), lanes_per_call):
        sel = slice(s, s + lanes_per_call)
        x, y = px[sel] % width, px[sel] // width
        o, d, h = camera_lanes(cam, x, y, width, height, ak[sel])
        frames[sel] = radiance(tables, settings, o, d, h, ak[sel], counts)
    frames = frames.reshape(accumulations, n, 3)
    buffer = torch.zeros((n, 3), dtype=dtype, device=device)
    for k in range(accumulations):
        buffer = buffer + (frames[k].to(dtype) - buffer) / (k + 1)
    return buffer.to(torch.float32)


def post_settings(tonemapper: str) -> CameraEffectsSettings:
    """The viewer's camera effects: the preset, its tonemapper, no grain."""
    return CameraEffectsSettings.preset()._replace(
        tonemapping_mode=TONEMAPPERS.index(tonemapper), film_grain=0.0)


def post(hdr, tonemapper: str, dtype=torch.float32):
    """``post/pipeline.process`` over an HDR image [h, w, 3]; ``dtype``
    rounds its input and output (the control's lower precision)."""
    ldr = process(hdr.to(dtype).to(torch.float32), post_settings(tonemapper))
    return ldr.to(dtype).to(torch.float32)
