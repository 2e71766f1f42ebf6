"""The mesh path tracer as one CUDA megakernel: scenes of up to 262,144
triangles, one kernel launch per frame.

Port of ``bifrost3d_tpu/integrator/pallas_mesh.py`` (``MAX_TRIS``,
``HIER_MAX_TRIS``, ``MAX_MATERIALS``, ``MAX_LIGHTS``, ``ATTR_ROWS``,
``megakernel_ineligibility_reasons``, ``mesh_megakernel_eligible``,
``_pack_scene``, ``_live_tables``, ``_static_info``, ``prewarm_megakernel``,
``_rho_tables``, ``render_mesh_megakernel`` with ``_render_packed``): its
dense branch (at most ``MAX_TRIS`` triangles) and its BVH branch
(``_hier_tracers``, above that). The TPU kernel ``_make_kernel`` becomes
the hand-written CUDA kernel ``csrc/mesh_megakernel.cu``: one thread per
pixel runs the whole progressive sample — the trace (dense Möller–Trumbore
over the scene's triangles in shared memory, or above ``MAX_TRIS`` a
per-thread walk of the port's own triangle BVH,
``geometry/pallas_bvh.py::HierTriangles``, in global memory), attribute
fetch by triangle index (dense) or by slot of the tree's leaf order (BVH),
Default (EON + GGX, optional coat) or Diffuse shading, RIS(≤ 8) NEE with
MIS over sphere, spot and directional lights, a binary any-hit shadow ray,
emission, the background tint, passthrough of back faces, and the
Owen-scrambled Sobol RNG — with the path state in registers.

:func:`render_mesh_megakernel` dispatches on the scene's device: CUDA
tensors launch the kernel, CPU tensors take the plain PyTorch version
:func:`mesh_megakernel_reference`, anything else raises. A failed build or
launch raises; nothing falls back. ``launch_count`` counts kernel launches.

On the BVH branch the lanes are handed to the kernel in small 2-D pixel
tiles, one per warp (``HIER_PIXEL_TILE``), so that a warp's rays stay
close in the tree; the image is put back in raster order afterwards.

The kernel's environment-map, NEAREST-texture and cutout (coverage-aware
shadow march) branches are not ported, on either trace: such scenes are
listed as ineligible, and ``render_sample_fast`` sends them to the
wavefront.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from bifrost3d_tpu_torch.geometry.bvh import STACK_SIZE
from bifrost3d_tpu_torch.geometry.pallas_bvh import (
    HierTriangles,
    hierarchical_intersect_reference,
    pack_hierarchical,
)
from bifrost3d_tpu_torch.geometry.pallas_intersect import (
    _check,
    dense_intersect_reference,
)
from bifrost3d_tpu_torch.integrator.path_tracer import (
    RenderSettings,
    _camera_lanes,
    _create_shading,
    _fix_backfacing_shading_normal,
    _reestimated_light_samples,
    _reverse_halton_offsets,
    mis_weight,
)
from bifrost3d_tpu_torch.lights.analytic import evaluate_light, light_pdf
from bifrost3d_tpu_torch.lights.types import (
    LIGHT_DIRECTIONAL,
    LIGHT_SPHERE,
    LIGHT_SPOT,
    LightArray,
)
from bifrost3d_tpu_torch.math.octahedral import octahedral_decode
from bifrost3d_tpu_torch.math.ray_offset import offset_ray_origin
from bifrost3d_tpu_torch.math.vec import (
    dot,
    gsafe,
    normalize,
    reflect,
    to_local,
    to_world,
)
from bifrost3d_tpu_torch.sampling.sobol import (
    Dimension,
    path_rng_4d,
    sobol_direction_numbers,
)
from bifrost3d_tpu_torch.scene.materials import (
    FLAG_CUTOUT,
    SHADING_DEFAULT,
    SHADING_DIFFUSE,
    SHADING_TRANSMISSIVE,
)
from bifrost3d_tpu_torch.scene.render_scene import RenderScene
from bifrost3d_tpu_torch.shading.fittings import get_fittings

MAX_TRIS = 1024
MAX_MATERIALS = 32
MAX_LIGHTS = 8
MAX_RIS = 8
ATTR_ROWS = 24            # attr table rows (19 used; padded to 8-multiple)
HIER_MAX_TRIS = 262144    # the BVH branch's cap
# Pixels per warp on the BVH branch, (width, height) of the tile a warp's 32
# lanes cover; None = raster order.
HIER_PIXEL_TILE = (8, 4)
_BIG = 3.0e38
_THREADS = 128            # the kernel's block size, one pixel per thread

launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


# -- eligibility -----------------------------------------------------------------

def megakernel_ineligibility_reasons(scene: RenderScene,
                                     settings: RenderSettings) -> list:
    """Every feature of this scene/settings combination outside the
    kernel's scope, as readable strings (empty = eligible): the JAX
    package's reasons, plus one for each branch not ported yet."""
    reasons = []
    t = int(scene.tri_verts.shape[0])
    if t == 0:
        reasons.append("empty scene")
    elif t > HIER_MAX_TRIS:
        reasons.append(f"{t} triangles > HIER_MAX_TRIS {HIER_MAX_TRIS}")
    if scene.environment is not None:
        reasons.append("environment map (not ported)")
    mats = scene.materials
    m = int(mats.shading_model.shape[0])
    if m == 0 or m > MAX_MATERIALS:
        reasons.append(f"{m} materials outside [1, {MAX_MATERIALS}]")
    if SHADING_TRANSMISSIVE in scene.shading_models:
        reasons.append("Transmissive shading model")
    if bool(torch.any(mats.metallic_texture >= 0)):
        reasons.append("metallic textures")
    if any(bool(torch.any(slot >= 0)) for slot in (
            mats.tint_roughness_texture, mats.metallic_texture,
            mats.coverage_texture)):
        reasons.append("textures (not ported)")
    if (settings.coverage_aware_shadows
            or bool(torch.any((mats.flags & FLAG_CUTOUT) != 0))):
        reasons.append("cutouts / coverage-aware shadows (not ported)")
    if not bool(torch.all(scene.tri_tint_roughness == 1.0)):
        reasons.append("per-vertex tint-roughness")
    kinds = scene.lights.kind
    if scene.lights.count > MAX_LIGHTS:
        reasons.append(f"{scene.lights.count} lights > MAX_LIGHTS "
                       f"{MAX_LIGHTS}")
    if not bool(torch.all((kinds == LIGHT_SPHERE) | (kinds == LIGHT_SPOT)
                          | (kinds == LIGHT_DIRECTIONAL))):
        reasons.append("unknown light kind")
    if settings.path_regularization_scale > 0.0:
        reasons.append("path regularization")
    if settings.next_event_sample_count > MAX_RIS:
        reasons.append(f"RIS count {settings.next_event_sample_count} > "
                       f"{MAX_RIS}")
    return reasons


def mesh_megakernel_eligible(scene: RenderScene,
                             settings: RenderSettings) -> bool:
    """True when the scene/settings combination is within the kernel's
    scope; everything else renders through the wavefront."""
    return not megakernel_ineligibility_reasons(scene, settings)


# -- packing ------------------------------------------------------------------------

_PACK_CACHE = {}
_STATIC_CACHE = {}


def _pack_scene(scene: RenderScene) -> dict:
    """Geometry tables on the scene's device, cached per scene identity:
    ``tri`` [t_pad, 16] (v0, e1, e2 in columns 0-8) and ``attr``
    [ATTR_ROWS, t_pad] (corner normals 0-8, material 9, unit geometric
    normal 10-12, corner uvs 13-18). Materials, lights, epsilon and the
    background are read from the live scene on every call instead.

    Above ``MAX_TRIS`` triangles (``hier``) ``tri`` is the packed BVH
    instead — the scene's own ``HierTriangles`` when it carries one, else
    one packed here over ``scene.bvh`` (built when the scene has none;
    a tree deeper than the walk's stack raises) — with ``order`` replaced
    by the identity, so that a walk answers with slots, and ``attr``
    [ATTR_ROWS, t] has its columns in slot order."""
    key = (id(scene.tri_verts), id(scene.tri_normals_oct),
           id(scene.tri_material))
    if key in _PACK_CACHE:
        return _PACK_CACHE[key]
    if len(_PACK_CACHE) > 32:
        _PACK_CACHE.clear()
    tv = scene.tri_verts.to(torch.float32)
    t = int(tv.shape[0])
    device = tv.device
    hier = t > MAX_TRIS
    t_pad = t if hier else max(8, ((t + 7) // 8) * 8)
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]

    geo_n = torch.linalg.cross(e1, e2, dim=-1)
    geo_n = geo_n / torch.clamp_min(
        torch.linalg.vector_norm(geo_n, dim=-1, keepdim=True), 1e-20)
    uvs = scene.tri_uvs.to(torch.float32)
    attr = torch.zeros((ATTR_ROWS, t_pad), dtype=torch.float32, device=device)
    attr[0:9, :t] = octahedral_decode(scene.tri_normals_oct).reshape(t, 9).T
    attr[9, :t] = scene.tri_material.to(torch.float32)
    attr[10:13, :t] = geo_n.T
    attr[13:16, :t] = uvs[:, :, 0].T
    attr[16:19, :t] = uvs[:, :, 1].T
    if hier:
        tree = scene.tri_clustered
        if not isinstance(tree, HierTriangles):
            tree = pack_hierarchical(tv, scene.bvh)
        attr = attr[:, tree.order.long()].contiguous()
        tri = tree._replace(order=torch.arange(t, dtype=torch.int32,
                                               device=device))
    else:
        tri = torch.zeros((t_pad, 16), dtype=torch.float32, device=device)
        tri[:t, 0:9] = torch.cat([tv[:, 0], e1, e2], dim=1)
    packed = dict(
        # Pin the keyed tensors: an id() key is sound only while they live.
        _pins=(scene.tri_verts, scene.tri_normals_oct, scene.tri_material),
        tri=tri, attr=attr, n_tris=t, hier=hier)
    _PACK_CACHE[key] = packed
    return packed


def _live_tables(scene: RenderScene):
    """→ (materials [m, 16], m, lights [n, 12]) from the live scene, laid
    out as in JAX. Material columns: tint 0-2, roughness 3, specularity 4,
    metallic 5, thin-walled 6 (cutouts too), emission 7-9, coverage 10,
    coat 11, coat roughness 12, shading model 13. Light columns: position
    0-2, radius 3, power 4-6, direction 7-9, cos_angle 10."""
    mats = scene.materials
    m = int(mats.shading_model.shape[0])
    device = scene.tri_verts.device
    f32 = lambda a: a.to(torch.float32).reshape(m, -1)   # noqa: E731
    if m:
        # Cutouts are implicitly thin-walled (Types.h:384).
        thin = (mats.flags & 3) != 0
        mat_tab = torch.cat([
            f32(mats.tint), f32(mats.roughness), f32(mats.specularity),
            f32(mats.metallic), f32(thin), f32(mats.emission),
            f32(mats.coverage), f32(mats.coat), f32(mats.coat_roughness),
            f32(mats.shading_model),
            torch.zeros((m, 2), dtype=torch.float32, device=device)], dim=1)
    else:
        mat_tab = torch.zeros((1, 16), dtype=torch.float32, device=device)
    lights = scene.lights
    n = lights.count
    if n:
        light_tab = torch.cat([
            lights.position.to(torch.float32),
            lights.radius.to(torch.float32)[:, None],
            lights.power.to(torch.float32),
            lights.direction.to(torch.float32),
            lights.cos_angle.to(torch.float32)[:, None],
            torch.zeros((n, 1), dtype=torch.float32, device=device)], dim=1)
    else:
        light_tab = torch.zeros((1, 12), dtype=torch.float32, device=device)
    return mat_tab.contiguous(), m, light_tab.contiguous()


def _static_info(scene: RenderScene) -> dict:
    """Kernel-structure statics read on the host and cached per identity:
    the light kinds (a runtime switch in the kernel) and whether any
    material has a coat (a template parameter)."""
    key = (id(scene.lights.kind), id(scene.materials.coat))
    if key in _STATIC_CACHE:
        return _STATIC_CACHE[key][0]
    if len(_STATIC_CACHE) > 32:
        _STATIC_CACHE.clear()
    info = dict(
        light_kinds=tuple(int(k) for k in scene.lights.kind.tolist()),
        has_coat=bool(torch.any(scene.materials.coat > 0.0)))
    _STATIC_CACHE[key] = (info, (scene.lights.kind, scene.materials.coat))
    return info


def _rho_tables(device):
    """The two 32×32 GGX rho tables, indexed [roughness][cos_theta]."""
    f = get_fittings(torch.device(device))
    return f.ggx, f.ggx_with_fresnel


def prewarm_megakernel(scene: RenderScene) -> None:
    """Fill the host-side caches for ``scene`` and, on a card, build the
    kernel, so that the first frame pays for neither."""
    _pack_scene(scene)
    _static_info(scene)
    if scene.tri_verts.device.type == "cuda":
        _library()


class KernelConfig(NamedTuple):
    """Static facts of one dispatch (the JAX ``cfg`` dict)."""

    n_tris: int
    light_kinds: tuple
    n_iters: int
    max_bounce: int
    ris_count: int
    firefly_clamp: float
    delta_light_clamp: float
    has_coat: bool
    has_diffuse: bool
    hier: bool = False      # the trace walks the BVH (``tri`` is the tree)


# -- the plain version --------------------------------------------------------

def _analytic_light_hits(lights, light_kinds, o, d):
    """Nearest sphere-light or spot-disk hit per lane → (t, light index),
    ``_BIG`` and -1 on a miss; a strict '<' in ascending light order."""
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


def _reference_tracers(tri, cfg: KernelConfig, eps, stats):
    """→ (closest(o, d, live) → Hit, occluded(o, d, t_max, live) → bool [p])
    of the plain version: the dense trace over the [t_pad, 16] table, or
    with ``cfg.hier`` the lockstep walk over the packed BVH ``tri`` (whose
    ``order`` is the identity, so prim ids are slots). Lanes outside
    ``live`` trace nothing on the BVH branch (t_max = 0 fails the root's
    box); their results are unspecified and masked by the caller."""
    if not cfg.hier:
        comp = tri.T                       # the B1 [16, t_pad] layout, a view

        def closest(o, d, live):
            return dense_intersect_reference(comp, cfg.n_tris, o, d, eps,
                                             float("inf"))

        def occluded(o, d, t_max, live):
            return dense_intersect_reference(comp, cfg.n_tris, o, d, eps,
                                             t_max).prim >= 0
        return closest, occluded

    def walk(o, d, t_max, any_hit):
        walk_stats = {} if stats is not None else None
        hit = hierarchical_intersect_reference(tri, o, d, eps, t_max,
                                               any_hit=any_hit,
                                               stats=walk_stats)
        if stats is not None:
            for key in ("box_tests", "tri_tests"):
                stats[key] = stats.get(key, 0) + int(walk_stats[key])
        return hit

    def closest(o, d, live):
        return walk(o, d, torch.where(live, float("inf"), 0.0), False)

    def occluded(o, d, t_max, live):
        return walk(o, d, torch.where(live, t_max, 0.0), True).prim >= 0
    return closest, occluded


def mesh_megakernel_reference(tri, attr, mats, lights, rho_ggx, rho_fres,
                              origin, direction, pixel_hash, active,
                              accumulation: int, scalars, cfg: KernelConfig,
                              stats=None):
    """Plain PyTorch version of the kernel over all lanes at once →
    (r, g, b, rays), each [p]. ``tri`` is the dense [t_pad, 16] table, or
    with ``cfg.hier`` the packed BVH (``_pack_scene``), whose walk is
    :func:`~bifrost3d_tpu_torch.geometry.pallas_bvh.hierarchical_intersect_reference`
    and whose hits index ``attr`` by slot. A ``stats`` dict, if given,
    receives the BVH walks' ``box_tests`` and ``tri_tests`` summed over
    the frame.

    Mirrors one iteration of the JAX ``_make_kernel`` step in order:
    closest hit, analytic-light hits, miss → background, light hit with
    MIS, attributes by triangle, material row, passthrough of culled back
    faces, shading, emission, RIS NEE with one any-hit shadow ray, BSDF
    sample. ``origin``/``direction`` [p, 3], ``pixel_hash`` int64 holding
    uint32 [p], ``active`` float 0/1 [p], ``scalars`` = (epsilon,
    background rgb). ``rho_ggx``/``rho_fres`` must be the device's own
    tables (:func:`_rho_tables`), which the shading reads. Runs on any
    device.
    """
    device = origin.device
    if not all(torch.equal(a, b) for a, b in zip(
            (rho_ggx, rho_fres), _rho_tables(device))):
        raise ValueError("the plain version shades with the fitted rho "
                         "tables of shading/fittings.py only")
    p = origin.shape[0]
    eps, env_tint = scalars[0], scalars[1:4]
    closest, occluded_by = _reference_tracers(tri, cfg, eps, stats)
    n_lights = len(cfg.light_kinds)
    light_arr = LightArray(
        kind=torch.tensor(cfg.light_kinds, dtype=torch.int32, device=device),
        position=lights[:n_lights, 0:3], radius=lights[:n_lights, 3],
        power=lights[:n_lights, 4:7], direction=lights[:n_lights, 7:10],
        cos_angle=lights[:n_lights, 10])
    hits_lights = any(k in (LIGHT_SPHERE, LIGHT_SPOT) for k in cfg.light_kinds)
    present = ((SHADING_DEFAULT, SHADING_DIFFUSE) if cfg.has_diffuse
               else (SHADING_DEFAULT,))

    o, d = origin, direction
    throughput = torch.ones((p, 3), dtype=torch.float32, device=device)
    radiance = torch.zeros((p, 3), dtype=torch.float32, device=device)
    bsdf_pdf = torch.zeros(p, dtype=torch.float32, device=device)
    bounce = torch.zeros(p, dtype=torch.int64, device=device)
    rays = torch.zeros(p, dtype=torch.float32, device=device)
    act = active > 0.0
    for _ in range(cfg.n_iters):
        live = act
        rays = rays + torch.where(live, 2.0, 0.0)
        hit = closest(o, d, live)
        hit_mask = hit.prim >= 0
        t_hit = torch.where(hit_mask, hit.t, _BIG)
        t_light, light_idx = _analytic_light_hits(lights, cfg.light_kinds,
                                                  o, d)
        light_first = t_light < t_hit
        mesh_hit = live & hit_mask & ~light_first
        light_hit = live & light_first & (light_idx >= 0)
        miss = live & ~hit_mask & ~light_first

        radiance = radiance + torch.where(miss[:, None],
                                          throughput * env_tint, 0.0)
        if hits_lights:
            li = torch.clamp_min(light_idx, 0)
            l_rad = evaluate_light(light_arr, li, o, d)
            l_pdf = light_pdf(light_arr, li, o, d)
            w = torch.where(bsdf_pdf > 0.0, mis_weight(bsdf_pdf, l_pdf), 1.0)
            clamped = torch.clamp_max(throughput, cfg.firefly_clamp)
            radiance = radiance + torch.where(light_hit[:, None],
                                              clamped * l_rad * w[:, None],
                                              0.0)

        # Attributes and material by triangle index.
        a = attr[:, torch.clamp_min(hit.prim, 0).long()]      # [24, p]
        hu, hv = hit.u, hit.v
        bary0 = 1.0 - hu - hv
        shading_n = normalize(a[0:3].T * bary0[:, None] + a[3:6].T * hu[:, None]
                              + a[6:9].T * hv[:, None])
        geo_n = a[10:13].T
        position = o + d * torch.where(hit_mask, t_hit, 0.0)[:, None]
        m = mats[a[9].long()]                                 # [p, 16]
        zero = torch.zeros_like(m[:, 11])
        coat = m[:, 11] if cfg.has_coat else zero
        coat_r = m[:, 12] if cfg.has_coat else zero
        model = m[:, 13].to(torch.int32) if cfg.has_diffuse else \
            zero.to(torch.int32)
        thin_walled = m[:, 6] > 0.5

        u_bsdf = path_rng_4d(accumulation, pixel_hash,
                             bounce * Dimension.PER_BOUNCE + Dimension.BSDF)
        u_nee = path_rng_4d(accumulation, pixel_hash,
                            bounce * Dimension.PER_BOUNCE + Dimension.NEE)

        hit_from_front = dot(geo_n, d) < 0.0
        backside_cull = ~hit_from_front & ~thin_walled
        passthrough = mesh_hit & backside_cull
        shade = mesh_hit & ~backside_cull
        front = hit_from_front[:, None]
        gf = torch.where(front, geo_n, -geo_n)
        sn = _fix_backfacing_shading_normal(
            -d, torch.where(front, shading_n, -shading_n))
        wo = to_local(-d, sn)
        cos_theta_o = torch.where(hit_from_front | thin_walled, wo[:, 2],
                                  -wo[:, 2])
        bundle = _create_shading(present, model, m[:, 0:3], m[:, 3], m[:, 4],
                                 m[:, 5], coat, coat_r,
                                 torch.abs(cos_theta_o))
        radiance = radiance + torch.where(shade[:, None],
                                          throughput * m[:, 7:10], 0.0)

        nee_valid = torch.zeros(p, dtype=torch.bool, device=device)
        if n_lights > 0 and cfg.ris_count > 0:
            l_dir, l_dist, l_rad, nee_valid = _reestimated_light_samples(
                light_arr, bundle, position, wo, sn, u_nee, cfg.ris_count,
                cfg.delta_light_clamp)
            l_rad = l_rad * throughput
            side = torch.where(dot(l_dir, gf) >= 0.0, 1.0, -1.0)
            shadow_origin = offset_ray_origin(position, gf * side[:, None])
            has_light = shade & (torch.amax(l_rad, dim=-1) > 0.0)
            occluded = occluded_by(shadow_origin, l_dir,
                                   l_dist * (1.0 - 1e-4), has_light)
            radiance = radiance + torch.where(
                (has_light & ~occluded)[:, None], l_rad, 0.0)

        s = bundle.sample(wo, u_bsdf[:, :3])
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
               & (bounce <= cfg.max_bounce))
    return radiance[:, 0], radiance[:, 1], radiance[:, 2], rays


# -- the CUDA kernel ---------------------------------------------------------------

class _Params(ctypes.Structure):
    """Mirror of ``MegakernelParams`` in csrc/mesh_megakernel.cu."""

    _fields_ = [
        ("tri", ctypes.c_void_p), ("nodes", ctypes.c_void_p),
        ("attr", ctypes.c_void_p),
        ("mats", ctypes.c_void_p), ("lights", ctypes.c_void_p),
        ("rho_ggx", ctypes.c_void_p), ("rho_fres", ctypes.c_void_p),
        ("sobol", ctypes.c_void_p), ("origin", ctypes.c_void_p),
        ("direction", ctypes.c_void_p), ("pixel_hash", ctypes.c_void_p),
        ("active", ctypes.c_void_p), ("scalars", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("n_pixels", ctypes.c_int), ("n_tris", ctypes.c_int),
        ("t_pad", ctypes.c_int), ("n_mats", ctypes.c_int),
        ("n_lights", ctypes.c_int), ("light_kinds", ctypes.c_int * MAX_LIGHTS),
        ("accumulation", ctypes.c_uint), ("n_iters", ctypes.c_int),
        ("max_bounce", ctypes.c_int), ("ris_count", ctypes.c_int),
        ("firefly_clamp", ctypes.c_float),
        ("delta_light_clamp", ctypes.c_float),
        ("ris_offsets", ctypes.c_float * (4 * MAX_RIS)),
        ("has_coat", ctypes.c_int), ("has_diffuse", ctypes.c_int),
        ("hier", ctypes.c_int),
    ]


@functools.lru_cache(maxsize=None)
def _library():
    from bifrost3d_tpu_torch.utils import cuda_build
    lib = cuda_build.load("mesh_megakernel.cu")
    lib.megakernel_params_size.restype = ctypes.c_int
    size = lib.megakernel_params_size()
    if size != ctypes.sizeof(_Params):
        raise RuntimeError(f"MegakernelParams is {size} bytes in the kernel "
                           f"but {ctypes.sizeof(_Params)} in ctypes")
    lib.mesh_megakernel.argtypes = [ctypes.POINTER(_Params), ctypes.c_int,
                                    ctypes.c_void_p]
    lib.mesh_megakernel.restype = ctypes.c_int
    lib.megakernel_rng_probe.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.megakernel_rng_probe.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sobol_dirs(device: torch.device) -> torch.Tensor:
    """The port's [4, 32] Sobol direction numbers as int32 bits on device."""
    dirs = sobol_direction_numbers().view(np.int32)
    return torch.tensor(dirs, device=device).contiguous()


def _as_int32_bits(x):
    """int64 tensor of uint32 values → int32 with the same 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def mesh_megakernel_cuda(tri, attr, mats, lights, rho_ggx, rho_fres, origin,
                         direction, pixel_hash, active, accumulation: int,
                         scalars, cfg: KernelConfig):
    """Launch ``csrc/mesh_megakernel.cu`` on the current stream →
    (r, g, b, rays), each [p]; the arguments are those of
    :func:`mesh_megakernel_reference` (``tri`` the dense table, or with
    ``cfg.hier`` the packed BVH)."""
    global launch_count
    device = origin.device
    p = int(origin.shape[0])
    if origin.shape != (p, 3) or direction.shape != (p, 3):
        raise ValueError("origin and direction must both be [p, 3]")
    if pixel_hash.shape != (p,) or active.shape != (p,):
        raise ValueError("pixel_hash and active must both be [p]")
    n_lights = len(cfg.light_kinds)
    if cfg.hier != isinstance(tri, HierTriangles):
        raise TypeError("tri must be the packed BVH with cfg.hier, the "
                        "dense [t_pad, 16] table without")
    nodes = None
    if cfg.hier:
        tree, nodes, tri = tri, tri.node_boxes, tri.tri_components
        if not 0 < cfg.n_tris <= HIER_MAX_TRIS or cfg.n_tris != tree.n_tris \
                or tri.shape != (cfg.n_tris, 12):
            raise ValueError(f"n_tris={cfg.n_tris} outside (0, "
                             f"{HIER_MAX_TRIS}] or not the packed tree's")
        if nodes.dim() != 2 or nodes.shape[1] != 8 or nodes.shape[0] < 1:
            raise ValueError("node_boxes must be [n >= 1, 8]")
        if tree.max_depth + 1 > STACK_SIZE:
            raise ValueError(f"BVH depth {tree.max_depth} exceeds the "
                             f"kernel stack ({STACK_SIZE})")
        _check("node_boxes", nodes, torch.float32, device)
    else:
        if not 0 < cfg.n_tris <= min(MAX_TRIS, tri.shape[0]):
            raise ValueError(f"n_tris={cfg.n_tris} outside (0, {MAX_TRIS}] "
                             "or the packed table")
        if tri.shape[1] != 16:
            raise ValueError("tri must be [t_pad, 16]")
    if attr.shape != (ATTR_ROWS, tri.shape[0]):
        raise ValueError(f"attr must be [{ATTR_ROWS}, t_pad]")
    if mats.shape[0] > MAX_MATERIALS or mats.shape[1] != 16:
        raise ValueError(f"mats must be [<= {MAX_MATERIALS}, 16]")
    if n_lights > MAX_LIGHTS or lights.shape[1] != 12 \
            or lights.shape[0] < n_lights:
        raise ValueError(f"lights must be [<= {MAX_LIGHTS}, 12], one row "
                         "per light kind")
    if not 0 <= cfg.ris_count <= MAX_RIS:
        raise ValueError(f"ris_count {cfg.ris_count} outside [0, {MAX_RIS}]")
    if rho_ggx.shape != (32, 32) or rho_fres.shape != (32, 32):
        raise ValueError("the rho tables must be [32, 32]")
    hashes = _as_int32_bits(pixel_hash).contiguous()
    sobol = _sobol_dirs(device)
    for name, x, dtype in (
            ("tri", tri, torch.float32), ("attr", attr, torch.float32),
            ("mats", mats, torch.float32), ("lights", lights, torch.float32),
            ("rho_ggx", rho_ggx, torch.float32),
            ("rho_fres", rho_fres, torch.float32),
            ("origin", origin, torch.float32),
            ("direction", direction, torch.float32),
            ("pixel_hash", hashes, torch.int32),
            ("active", active, torch.float32),
            ("scalars", scalars, torch.float32)):
        _check(name, x, dtype, device)
    if scalars.shape != (4,):
        raise ValueError("scalars must be [4]: epsilon, background rgb")

    out = torch.empty((4, p), dtype=torch.float32, device=device)
    params = _Params(
        tri=tri.data_ptr(), nodes=0 if nodes is None else nodes.data_ptr(),
        attr=attr.data_ptr(), mats=mats.data_ptr(),
        lights=lights.data_ptr(), rho_ggx=rho_ggx.data_ptr(),
        rho_fres=rho_fres.data_ptr(), sobol=sobol.data_ptr(),
        origin=origin.data_ptr(), direction=direction.data_ptr(),
        pixel_hash=hashes.data_ptr(), active=active.data_ptr(),
        scalars=scalars.data_ptr(), out=out.data_ptr(),
        n_pixels=p, n_tris=cfg.n_tris, t_pad=int(tri.shape[0]),
        n_mats=int(mats.shape[0]), n_lights=n_lights,
        accumulation=int(accumulation) & 0xFFFFFFFF, n_iters=cfg.n_iters,
        max_bounce=cfg.max_bounce, ris_count=cfg.ris_count,
        firefly_clamp=cfg.firefly_clamp,
        delta_light_clamp=cfg.delta_light_clamp,
        has_coat=int(cfg.has_coat), has_diffuse=int(cfg.has_diffuse),
        hier=int(cfg.hier))
    for k, kind in enumerate(cfg.light_kinds):
        params.light_kinds[k] = kind
    for k, v in enumerate(_reverse_halton_offsets(MAX_RIS).reshape(-1)):
        params.ris_offsets[k] = float(v)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _library().mesh_megakernel(ctypes.byref(params), _THREADS, stream)
    if err != 0:
        raise RuntimeError(f"mesh_megakernel launch failed: cudaError {err}")
    launch_count += 1
    return out[0], out[1], out[2], out[3]


def rng_probe(accumulation: int, pixel_hash, dimension):
    """The kernel's ``path_rng_4d`` on the card → float32 [n, 4], for
    holding it bit for bit against :func:`sampling.sobol.path_rng_4d`.
    ``pixel_hash`` and ``dimension`` are int64 [n] of uint32 values."""
    device = pixel_hash.device
    n = int(pixel_hash.shape[0])
    hashes = _as_int32_bits(pixel_hash).contiguous()
    dims = _as_int32_bits(dimension).contiguous()
    out = torch.empty((n, 4), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _library().megakernel_rng_probe(
        hashes.data_ptr(), dims.data_ptr(), n, int(accumulation) & 0xFFFFFFFF,
        _sobol_dirs(device).data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"megakernel_rng_probe launch failed: "
                           f"cudaError {err}")
    return out


# -- entry point ---------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def pixel_order(width: int, height: int, tile, device) -> torch.Tensor:
    """int64 [width·height]: the flat raster index of the pixel each lane
    renders. ``tile`` = (tw, th) hands consecutive runs of tw·th lanes one
    tw × th pixel tile each, tiles in raster order; None, or a frame the
    tile does not divide, gives raster order."""
    flat = torch.arange(width * height, dtype=torch.int64, device=device)
    if tile is None or width % tile[0] or height % tile[1]:
        return flat
    tw, th = tile
    return flat.reshape(height // th, th, width // tw, tw).permute(
        0, 2, 1, 3).reshape(-1)


def megakernel_inputs(scene: RenderScene, camera, width: int, height: int,
                      accumulation: int,
                      settings: RenderSettings = RenderSettings(),
                      pixel_tile=None) -> tuple:
    """The kernel's arguments for one frame (those of
    :func:`mesh_megakernel_reference` and :func:`mesh_megakernel_cuda`).

    Geometry tables come from the per-identity pack cache; materials,
    lights, epsilon and the background are read from the live scene.
    Camera rays, pcg2d pixel hashes and the active mask are made in torch,
    one lane per pixel in the order of :func:`pixel_order` (raster order
    without a ``pixel_tile``: the JAX dense branch's identity layout). A
    pixel's result does not depend on its lane.
    """
    packed = _pack_scene(scene)
    mats, _, lights = _live_tables(scene)
    info = _static_info(scene)
    device = scene.tri_verts.device
    rho_ggx, rho_fres = _rho_tables(device)
    cfg = KernelConfig(
        n_tris=packed["n_tris"], light_kinds=info["light_kinds"],
        n_iters=settings.max_bounce_count + 1 + settings.passthrough_slack,
        max_bounce=settings.max_bounce_count,
        ris_count=settings.next_event_sample_count,
        firefly_clamp=float(settings.firefly_clamp),
        delta_light_clamp=float(settings.delta_light_clamp),
        has_coat=info["has_coat"],
        has_diffuse=SHADING_DIFFUSE in scene.shading_models,
        hier=packed["hier"])
    accumulation = int(accumulation)
    flat = pixel_order(width, height, pixel_tile, device)
    lanes = _camera_lanes(camera, flat % width, flat // width, width, height,
                          accumulation, torch.ones_like(flat, dtype=torch.bool))
    scalars = torch.cat([scene.scene_epsilon.reshape(1).to(torch.float32),
                         scene.environment_tint.to(torch.float32)])
    return (packed["tri"], packed["attr"], mats, lights, rho_ggx, rho_fres,
            lanes.origin.contiguous(), lanes.direction.contiguous(),
            lanes.pixel_hash, lanes.active.to(torch.float32), accumulation,
            scalars, cfg)


def render_mesh_megakernel(scene: RenderScene, camera, width: int,
                           height: int, accumulation: int,
                           settings: RenderSettings = RenderSettings()):
    """One progressive frame through the mesh megakernel → (radiance
    [height, width, 3], rays [] — live lanes × 2 per iteration, the same
    in-run tally the pooled wavefront reports). A scene over ``MAX_TRIS``
    triangles renders its lanes in ``HIER_PIXEL_TILE`` tiles."""
    tile = HIER_PIXEL_TILE if _pack_scene(scene)["hier"] else None
    args = megakernel_inputs(scene, camera, width, height, accumulation,
                             settings, tile)
    device = scene.tri_verts.device
    if device.type == "cuda":
        r, g, b, rays = mesh_megakernel_cuda(*args)
    elif device.type == "cpu":
        r, g, b, rays = mesh_megakernel_reference(*args)
    else:
        raise ValueError(f"no mesh megakernel for a scene on {device}")
    img = torch.stack([r, g, b], dim=-1)
    if tile is not None:
        raster = torch.empty_like(img)
        raster[pixel_order(width, height, tile, device)] = img
        img = raster
    return img.reshape(height, width, 3), rays.sum()
