"""Wavefront mesh path tracer with NEE (RIS) + MIS, and its gradients.

Port of ``bifrost3d_tpu/integrator/path_tracer.py``: ``RenderSettings``,
``settings_for_scene``, ``mis_weight``, ``_sample_single_light``,
``_reestimated_light_samples``, ``_intersect_analytic_lights``,
``_fetch_tri_attributes``, ``_surface_material_params``,
``_fetch_tri_uv_mat``, ``_coverage_at_hit``, ``_shadow_transmittance``,
``_HitRecords``, ``_wavefront_step`` (with ``record`` and ``replay``),
``_pixel_lane_state``, ``render_sample_pixels``,
``render_sample_pixels_detached``, ``render_sample``, ``render_rays``,
``_make_camera_lanes``, ``render_pixels_pooled`` (the pool sort of its
loop body is ``pool_sort_order``), ``render_sample_pooled``,
``render_sample_pooled_counted``, ``explain_render_path``,
``render_sample_fast`` and ``render_progressive``, with the per-lane
Default/Diffuse/Transmissive model select of ``_ShadingBundle``.

Each wavefront step makes two scene queries through
``geometry.traverse.intersect_scene`` — a closest hit and an any-hit
shadow ray, or with ``coverage_aware_shadows`` a march of up to
``shadow_coverage_steps`` closest hits through semi-transparent surfaces —
which on CUDA tensors launch a hand-written trace kernel: the
dense one for a scene of at most 65,536 triangles, the BVH one above. For
a BVH scene the pool is sorted before every step (origin Morton code +
direction octant, dead lanes last), so neighbouring threads walk
neighbouring subtrees and the kernel skips the dead suffix. RNG is the
Owen-scrambled Sobol chain keyed by (accumulation, pcg2d pixel hash,
8·bounce + dim), exactly as in JAX.

Gradients: the scene queries are detached, as JAX's ``stop_gradient``
sites are (:func:`_scene_query`): rays and scene tables go in without
autograd history, hits, occlusion and shadow transmittance come out
without it, so autograd differentiates the estimator (attributes,
shading, light sampling, throughput) with the hit query treated as a
sampler, and no trace kernel has a backward. The analytic light hits stay
differentiable: that is how a light's position gets its gradient.
``render_sample`` goes through :func:`render_sample_pixels`, where
``remat_bounces`` recomputes each iteration in the backward
(``torch.utils.checkpoint``) and ``detached_replay_vjp`` differentiates a
replay of the recorded hits that traces no ray.

JAX's ``fori_loop``/``while_loop`` become Python loops. The pooled loop's
``any(active)`` condition costs one ``.item()`` (a host sync) per
iteration. ``render_sample_fast`` sends a scene on a CUDA card that the
mesh megakernel can take (``integrator/pallas_mesh.py``) through it, in
one kernel launch per frame, and every other scene through the pooled
wavefront, as JAX does with "tpu" read as "cuda".

A miss evaluates the scene's environment map with MIS against the last
BSDF sample, the environment is one more NEE candidate (its presampled
pool, or a search of its CDFs), textures scale tint, roughness, metallic
and coverage, and coverage below a random number lets the ray pass.
Trilinear textures take their mip level from the ray footprint
(``_camera_pixel_angle`` × hit distance × texel density); path
regularization raises both roughnesses of a hit to the minimum that keeps
the peak BSDF pdf below the previous bounce's, scaled (MonteCarlo.cu:239-244).
"""

from __future__ import annotations

import functools
import logging
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from bifrost3d_tpu_torch.geometry.traverse import (
    Hit,
    intersect_scene,
    intersect_scene_any,
)
from bifrost3d_tpu_torch.lights.analytic import (
    _ray_sphere_t,
    evaluate_light,
    light_pdf,
    sample_light,
)
from bifrost3d_tpu_torch.io.texture import sample_texture
from bifrost3d_tpu_torch.lights.environment import (
    environment_evaluate,
    environment_pdf,
    environment_sample,
    presampled_environment_sample,
)
from bifrost3d_tpu_torch.lights.types import (
    LIGHT_SPHERE,
    LIGHT_SPOT,
    LightArray,
    LightSample,
)
from bifrost3d_tpu_torch.bsdf.ggx import roughness_from_alpha
from bifrost3d_tpu_torch.math.clip import absolute, maximum, minimum
from bifrost3d_tpu_torch.math.octahedral import octahedral_decode
from bifrost3d_tpu_torch.math.ray_offset import offset_ray_origin
from bifrost3d_tpu_torch.math.vec import (
    cross,
    dot,
    normalize,
    reflect,
    to_local,
    to_world,
)
from bifrost3d_tpu_torch.sampling.hashes import pcg2d
from bifrost3d_tpu_torch.sampling.sobol import Dimension, path_rng_4d
from bifrost3d_tpu_torch.scene.camera import PinholeCamera, camera_ray_directions
from bifrost3d_tpu_torch.scene.materials import (
    FLAG_CUTOUT,
    FLAG_THIN_WALLED,
    SHADING_DEFAULT,
    SHADING_DIFFUSE,
    SHADING_TRANSMISSIVE,
)
from bifrost3d_tpu_torch.scene.render_scene import RenderScene
from bifrost3d_tpu_torch.shading.default_shading import DefaultShading
from bifrost3d_tpu_torch.shading.diffuse_shading import DiffuseShading
from bifrost3d_tpu_torch.shading.fittings import (
    estimate_ggx_alpha_from_max_pdf,
)
from bifrost3d_tpu_torch.shading.transmissive_shading import (
    TransmissiveShading,
)
from bifrost3d_tpu_torch.utils.profiling import span
from bifrost3d_tpu_torch.utils.tree import tree_flatten
from bifrost3d_tpu_torch.utils.versioned import VersionedCache

logger = logging.getLogger(__name__)


class RenderSettings(NamedTuple):
    """Per-camera settings (Renderer.h:47-63): the JAX package's fields in
    its order, so that a call with either package's arguments, positional
    or by keyword, builds the same settings.

    ``path_regularization_scale`` > 0 turns path regularization on, its
    scale growing by ``path_regularization_decay`` per accumulation;
    ``trilinear_textures`` is the hint that the texture bank holds
    trilinear samplers (the ray footprint is then computed for their mip
    level). ``coverage_aware_shadows`` is the hint that
    the scene holds semi-transparent surfaces (coverage < 1, coverage
    textures or cutouts): shadow rays then march through up to
    ``shadow_coverage_steps`` surfaces, multiplying by 1 - coverage
    (MonteCarlo.cu:278-285), instead of one binary any-hit query.
    ``passthrough_slack`` are the extra iterations granted for coverage and
    back-face passthrough, which spend no bounce.
    ``use_presampled_environment`` takes the environment's NEE candidate
    from the scene's presampled pool when it carries one, else from a search
    of its CDFs. ``sort_rays_every`` sorts the pool for the BVH trace kernel
    every that many steps (0 = never; ``settings_for_scene`` sets 1 for a
    scene that carries the BVH packing).
    ``remat_bounces`` recomputes each wavefront iteration of
    :func:`render_sample_pixels` in the backward instead of keeping its
    intermediates (``torch.utils.checkpoint``); ``detached_replay_vjp``
    takes the backward from a replay of the forward's recorded hits, which
    traces no ray (:func:`render_sample_pixels_detached`). Neither changes
    a forward frame. ``shading_models_present`` is accepted and changes
    no frame: the port reads the models present from the material table
    (``RenderScene.shading_models``).
    """

    max_bounce_count: int = 4
    next_event_sample_count: int = 3
    path_regularization_scale: float = 0.0   # 0 = off
    path_regularization_decay: float = 0.0
    firefly_clamp: float = 4.0
    delta_light_clamp: float = 32.0
    coverage_aware_shadows: bool = False
    shadow_coverage_steps: int = 4
    passthrough_slack: int = 2
    use_presampled_environment: bool = True
    shading_models_present: tuple = (0, 1, 2)
    sort_rays_every: int = 0
    trilinear_textures: bool = False
    remat_bounces: bool = False
    detached_replay_vjp: bool = False


def settings_for_scene(scene: RenderScene, **overrides) -> RenderSettings:
    """RenderSettings with the static scene hints filled from the material
    table (semi-transparency) and the texture bank (trilinear samplers),
    and ``remat_bounces`` on, as in JAX (it changes only the backward)."""
    mats = scene.materials
    semi_transparent = bool(
        torch.any(mats.coverage < 1.0)
        or torch.any(mats.coverage_texture >= 0)
        or torch.any((mats.flags & FLAG_CUTOUT) != 0))
    overrides.setdefault("coverage_aware_shadows", semi_transparent)
    if semi_transparent:
        overrides.setdefault("passthrough_slack", 8)
    overrides.setdefault("sort_rays_every",
                         1 if scene.tri_clustered is not None else 0)
    overrides.setdefault("trilinear_textures",
                         scene.textures is not None
                         and scene.textures.has_trilinear())
    overrides.setdefault("remat_bounces", True)
    return RenderSettings(**overrides)


def _reverse_halton_offsets(count: int = 8) -> np.ndarray:
    """4D reverse-Halton toroidal-shift offsets (Renderer.cpp:323-336);
    offset 0 is (0, 0, 0, 0)."""
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


@functools.lru_cache(maxsize=None)
def _ris_offsets(device: torch.device) -> torch.Tensor:
    """Read-only [8, 4] RIS candidate offsets on ``device``."""
    return torch.as_tensor(_reverse_halton_offsets(8), device=device)


def mis_weight(pdf1, pdf2):
    """Balance heuristic with inf/NaN handling (MonteCarlo.h:20-25)."""
    divisor = pdf1 + pdf2
    result = pdf1 / torch.where(divisor == 0.0, 1.0, divisor)
    invalid = torch.isinf(divisor) | torch.isnan(result)
    return torch.where(invalid, torch.where(pdf1 <= pdf2, 0.0, 1.0), result)


def _toroidal_shift(base, shift):
    s = base + shift
    return s - torch.floor(s)


def _fix_backfacing_shading_normal(w, n, target_cos=0.002):
    cos_theta = dot(w, n, keepdims=True)
    fixed = normalize(n - (cos_theta - target_cos) * w)
    return torch.where(cos_theta < target_cos, fixed, n)


# -- shading-model dispatch (masked evaluate-all) ---------------------------------

def _select_model(model, parts):
    """Field-wise select of per-model NamedTuple results by the lane's
    model; the first part is the default."""
    out = parts[0][1]
    for m, res in parts[1:]:
        sel = model == m
        out = type(out)(*(
            torch.where(sel[..., None] if a.dim() > sel.dim() else sel, b, a)
            for a, b in zip(out, res)))
    return out


class _ShadingBundle(NamedTuple):
    """The scene's shading models, each built for every lane; the lane's
    ``model`` picks which one answers (JAX ``_ShadingBundle``)."""

    default: Optional[DefaultShading]
    diffuse: Optional[DiffuseShading]
    transmissive: Optional[TransmissiveShading]
    model: torch.Tensor   # [...] int32

    def _parts(self):
        return [(m, s) for m, s in ((SHADING_DEFAULT, self.default),
                                    (SHADING_DIFFUSE, self.diffuse),
                                    (SHADING_TRANSMISSIVE, self.transmissive))
                if s is not None]

    def evaluate_with_pdf(self, wo, wi):
        return _select_model(self.model, [
            (m, s.evaluate_with_pdf(wo, wi)) for m, s in self._parts()])

    def sample(self, wo, u3):
        return _select_model(self.model, [
            (m, s.sample(wo, u3)) for m, s in self._parts()])


def _create_shading(present, model, tint, roughness, specularity, metallic,
                    coat, coat_roughness, cos_theta_o,
                    thin_walled=None, min_roughness=None) -> _ShadingBundle:
    """Build only the models in ``present`` (static); per-lane params.
    ``cos_theta_o`` is signed (negative seen from inside), as the
    Transmissive model needs it. Both roughnesses are held at the path
    regularization's minimum roughness ``min_roughness`` (per lane), or
    while it is off (None) at zero, as JAX's are: at a tie the gradient
    splits in half."""
    if min_roughness is None:
        roughness = maximum(roughness, 0.0)
        coat_roughness = maximum(coat_roughness, 0.0)
    else:
        roughness = torch.maximum(roughness, min_roughness)
        coat_roughness = torch.maximum(coat_roughness, min_roughness)
    default = DefaultShading.create(
        tint=tint, roughness=roughness, specularity=specularity,
        metallic=metallic, coat=coat, coat_roughness=coat_roughness,
        abs_cos_theta_o=torch.abs(cos_theta_o)) \
        if SHADING_DEFAULT in present else None
    diffuse = DiffuseShading.create(tint=tint, roughness=roughness) \
        if SHADING_DIFFUSE in present else None
    transmissive = TransmissiveShading.create(
        tint=tint, roughness=roughness, specularity=specularity,
        cos_theta_o=cos_theta_o, thin_walled=thin_walled) \
        if SHADING_TRANSMISSIVE in present else None
    return _ShadingBundle(default, diffuse, transmissive, model)


# -- light sampling (NEE with RIS) ---------------------------------------------

def _environment_sampler(scene: RenderScene, settings: RenderSettings):
    """The environment's NEE candidate as ``u3 -> LightSample``, or None
    when the scene has no map or its pool holds one sample (the map had no
    usable importance, PresampledEnvironmentMap.h:64): the pool indexed by
    ``u3[..., 0]``, or a search of the CDFs with ``u3[..., :2]``."""
    if scene.environment is None:
        return None
    pool = scene.environment_presampled
    if settings.use_presampled_environment and pool is not None:
        if pool.sample_count <= 1:
            return None
        return lambda u3: presampled_environment_sample(pool, u3[..., 0])
    return lambda u3: environment_sample(scene.environment, u3[..., :2])


def _sample_single_light(lights: LightArray, bundle: _ShadingBundle, position,
                         wo, shading_normal, u3, delta_light_clamp: float,
                         env_sampler=None):
    """One NEE candidate (MonteCarlo.cu:61-87) → (direction, distance,
    weighted radiance, pdf valid). With an ``env_sampler``
    (:func:`_environment_sampler`) the environment is candidate
    ``lights.count``."""
    n_lights = lights.count
    total = n_lights + (1 if env_sampler is not None else 0)
    if total == 0:
        z = torch.zeros(position.shape[:-1], device=position.device)
        return position, z, torch.zeros_like(position), z > 0.0
    pick = torch.clamp_max((u3[..., 2] * total).to(torch.int32), total - 1)
    if n_lights > 0:
        ls = sample_light(lights, torch.clamp_max(pick, n_lights - 1),
                          position, u3[..., :2])
    if env_sampler is not None:
        es = env_sampler(u3)
        if n_lights > 0:
            is_env = pick == n_lights
            ls = LightSample(*(
                torch.where(is_env[..., None] if e.dim() > is_env.dim()
                            else is_env, e, l) for e, l in zip(es, ls)))
        else:
            ls = es
    radiance = ls.radiance * total   # uniform light pick
    n_dot_l = dot(shading_normal, ls.direction)
    safe_pdf = maximum(ls.pdf, 1e-12)
    radiance = radiance * (torch.abs(n_dot_l) / safe_pdf)[..., None]
    radiance = torch.where((ls.pdf > 0.0)[..., None], radiance, 0.0)

    wi = to_local(ls.direction, shading_normal)
    f, bsdf_pdf = bundle.evaluate_with_pdf(wo, wi)
    weight = torch.where(ls.is_delta, 1.0, mis_weight(ls.pdf, bsdf_pdf))
    f = torch.where(ls.is_delta[..., None],
                    minimum(f, delta_light_clamp), f)
    radiance = radiance * weight[..., None] * f
    return ls.direction, ls.distance, radiance, ls.pdf > 1e-6


def _reestimated_light_samples(lights: LightArray, bundle, position, wo,
                               shading_normal, u4_base, ris_count: int,
                               delta_light_clamp: float, env_sampler=None):
    """RIS over ``ris_count`` candidates (MonteCarlo.cu:91-123) →
    (direction, distance, radiance, pdf valid of the selected one)."""
    direction = torch.zeros_like(position)
    distance = torch.zeros(position.shape[:-1], device=position.device)
    radiance = torch.zeros_like(position)
    pdf_valid = torch.zeros(position.shape[:-1], dtype=torch.bool,
                            device=position.device)
    if ris_count <= 0:
        return direction, distance, radiance, pdf_valid
    offsets = _ris_offsets(position.device)
    for s in range(ris_count):
        u4 = _toroidal_shift(u4_base, offsets[s])
        new_dir, new_dist, new_rad, new_valid = _sample_single_light(
            lights, bundle, position, wo, shading_normal, u4[..., :3],
            delta_light_clamp, env_sampler)
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


# -- the wavefront step -------------------------------------------------------------

def _intersect_analytic_lights(scene: RenderScene, origin, direction):
    """Nearest sphere-light or spot-disk hit → (t [r], light index [r])."""
    r = origin.shape[0]
    lights = scene.lights
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
    t_disk = dot(pos - o, ldir) / torch.where(torch.abs(denom) > 1e-9, denom, 1e-9)
    off = o + d * t_disk[..., None] - pos
    on_disk = torch.sum(off * off, dim=-1) <= radius * radius
    t_disk = torch.where(on_disk & (torch.abs(denom) > 1e-9), t_disk, -1.0)

    t = torch.where(is_sphere[None, :], t_sphere,
                    torch.where(is_spot[None, :], t_disk, -1.0))
    t = torch.where((t > 0) & (radius > 0), t, float("inf"))
    t_min = torch.amin(t, dim=1)
    idx = torch.argmin(t, dim=1).to(torch.int32)
    return t_min, torch.where(torch.isfinite(t_min), idx, -1)


def _fetch_tri_attributes(scene: RenderScene, prim):
    """Per-triangle attributes of lanes ``prim`` → (verts [r,3,3], corner
    normals [r,3,3], uvs [r,3,2], tint_roughness [r,3,4], material [r]).
    Plain row gathers (the JAX one-hot contraction is an exact
    selection)."""
    p = prim.long()
    return (scene.tri_verts[p], octahedral_decode(scene.tri_normals_oct[p]),
            scene.tri_uvs[p], scene.tri_tint_roughness[p],
            scene.tri_material[p])


def _interpolate(bary, attr):
    """Σ_k bary[r, k] · attr[r, k, c]."""
    return torch.sum(bary[..., None] * attr, dim=1)


def _surface_material_params(scene: RenderScene, mats, texcoord,
                             tint_roughness_scale=None, footprint_uv=None,
                             trilinear: bool = False):
    """Per-hit material parameters: constants × texture fetches ×
    per-vertex tint-roughness scale (the reference's get_tint_roughness /
    get_metallic / get_coverage, Types.h:353-416) → (tint, roughness,
    metallic, coverage). ``mats`` is the per-lane ``materials.gather``;
    ``footprint_uv`` and ``trilinear`` select trilinear textures' mip
    levels (:func:`sample_texture`)."""
    tint = mats.tint
    roughness = mats.roughness
    metallic = mats.metallic
    coverage_or_threshold = mats.coverage
    fetch = functools.partial(sample_texture, scene.textures, uv=texcoord,
                              footprint_uv=footprint_uv, trilinear=trilinear)
    tr = fetch(mats.tint_roughness_texture)
    tint = tint * tr[..., :3]
    roughness = roughness * tr[..., 3]
    metallic = metallic * fetch(mats.metallic_texture)[..., 0]
    coverage_tex = fetch(mats.coverage_texture)[..., 0]
    # A cutout binarizes the texture sample against the stored value, which
    # is then a threshold, not a coverage (Types.h:405-413; coverage and
    # cutout_threshold share storage, Material.h:84-85).
    is_cutout = (mats.flags & FLAG_CUTOUT) != 0
    coverage = torch.where(
        is_cutout,
        torch.where(coverage_tex < coverage_or_threshold, 0.0, 1.0),
        coverage_or_threshold * coverage_tex)
    if tint_roughness_scale is not None:
        tint = tint * tint_roughness_scale[..., :3]
        roughness = roughness * tint_roughness_scale[..., 3]
    return tint, roughness, metallic, coverage


def _fetch_tri_uv_mat(scene: RenderScene, prim):
    """The uvs [r, 3, 2] and material ids [r] of lanes ``prim``: what the
    coverage of a shadow-ray hit needs."""
    p = prim.long()
    return scene.tri_uvs[p], scene.tri_material[p]


def _coverage_at_hit(scene: RenderScene, hit):
    """Coverage of the surface at a Hit (cutout binarization included)."""
    uv, mat_idx = _fetch_tri_uv_mat(scene, torch.clamp_min(hit.prim, 0))
    bary = torch.stack([1.0 - hit.u - hit.v, hit.u, hit.v], dim=-1)
    _, _, _, coverage = _surface_material_params(
        scene, scene.materials.gather(mat_idx), _interpolate(bary, uv))
    return coverage


_DETACHED = VersionedCache(16)


def _no_graph(x):
    """A scene table (a tensor, a NamedTuple of them, or anything else)
    without autograd history. A tensor that requires grad becomes its
    detached alias, the same object for as long as the tensor is unchanged
    (cached per identity and version), so the trace kernels' table caches,
    keyed the same way, keep hitting across the steps of a frame."""
    if isinstance(x, torch.Tensor):
        if not x.requires_grad:
            return x
        key, alias = _DETACHED.lookup((x,))
        return alias if alias is not None else _DETACHED.store(
            key, (x,), x.detach())
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        fields = [_no_graph(f) for f in x]
        return x if all(a is b for a, b in zip(fields, x)) else \
            type(x)._make(fields)
    return x


def _scene_query(query, scene: RenderScene, origin, direction, t_min,
                 t_max=float("inf"), live_count=None):
    """``query`` (``intersect_scene`` or ``intersect_scene_any``) detached,
    as JAX's ``stop_gradient`` around the query and its rays: the rays,
    bounds and scene tables go in without autograd history and the result
    comes out without it, so no trace kernel or table cache ever sees a
    graph."""
    def bare(x):
        return x.detach() if isinstance(x, torch.Tensor) else x
    with torch.no_grad():
        return query(_no_graph(scene.bvh), _no_graph(scene.tri_verts),
                     bare(origin), bare(direction), t_min=_no_graph(t_min),
                     t_max=bare(t_max),
                     tri_components=_no_graph(scene.tri_components),
                     tri_clustered=_no_graph(scene.tri_clustered),
                     live_count=live_count)


def _shadow_transmittance(scene: RenderScene, origin, direction, t_max, eps,
                          steps: int):
    """Shadow-ray transmittance through semi-transparent surfaces.

    The reference's shadow_any_hit multiplies the shadow throughput by
    1 - coverage at every surface along the segment and ends when black
    (MonteCarlo.cu:278-285). A wavefront has no any-hit enumeration, so
    this marches the closest hit up to ``steps`` times, moving the origin
    past each intersection. Surfaces beyond ``steps`` occlude fully. A
    query like the others: the caller runs it under ``torch.no_grad``.
    """
    trans = torch.ones(origin.shape[0], dtype=torch.float32,
                       device=origin.device)
    t_remaining = t_max
    for step in range(steps):
        hit = _scene_query(intersect_scene, scene, origin, direction, eps,
                           t_remaining)
        blocked = hit.mask & (trans > 0.0)
        if step == steps - 1:
            # Budget exhausted: any remaining surface fully occludes.
            return torch.where(blocked, 0.0, trans)
        coverage = _coverage_at_hit(scene, hit)
        trans = torch.where(blocked, trans * (1.0 - coverage), trans)
        advance = torch.where(hit.mask, hit.t, 0.0) + eps
        origin = origin + direction * advance[..., None]
        t_remaining = t_remaining - advance
    return trans


class _PathState(NamedTuple):
    origin: torch.Tensor
    direction: torch.Tensor
    throughput: torch.Tensor
    radiance: torch.Tensor
    bsdf_pdf: torch.Tensor        # last BSDF pdf (MIS); <= 0 disables MIS
    bsdf_was_delta: torch.Tensor  # bool: the last bounce was a delta lobe
    pixel_hash: torch.Tensor      # int64 holding uint32
    bounce: torch.Tensor          # int64 per-lane bounce counter
    active: torch.Tensor


class _HitRecords(NamedTuple):
    """One wavefront iteration's scene-query results: the only values the
    estimator takes from the geometry, all without autograd history.
    Recording them makes the bounce loop replayable without a trace; the
    replay recomputes every differentiable quantity (attributes, shading,
    RIS NEE, sampling transforms) from these and the RNG chain."""

    t: torch.Tensor             # [r] hit distance (inf on miss)
    prim: torch.Tensor          # [r] int32
    u: torch.Tensor             # [r]
    v: torch.Tensor             # [r]
    shadow_trans: torch.Tensor  # [r] NEE shadow transmittance


def _wavefront_step(scene: RenderScene, settings: RenderSettings,
                    accumulation: int, state: _PathState,
                    pixel_angle=None, live_count=None,
                    replay: Optional[_HitRecords] = None,
                    record: bool = False):
    """One iteration for every lane: trace, environment or light hits,
    shade, NEE with a shadow trace or march, BSDF sample → the next
    _PathState (and with ``record`` this iteration's _HitRecords).
    ``pixel_angle`` (:func:`_camera_pixel_angle`) drives the ray footprint
    of trilinear textures. ``live_count`` (int tensor, optional): the
    pool's sorted live prefix, which the trace kernels stop at. ``replay``:
    a previous run's records instead of the scene queries, so the step
    traces nothing."""
    (origin, direction, throughput, radiance, bsdf_pdf, bsdf_was_delta,
     pixel_hash, bounce, active) = state
    eps = scene.scene_epsilon

    if replay is not None:
        hit = Hit(t=replay.t, prim=replay.prim, u=replay.u, v=replay.v)
    else:
        hit = _scene_query(intersect_scene, scene, origin, direction, eps,
                           live_count=live_count)
    t_light, light_idx = _intersect_analytic_lights(scene, origin, direction)

    light_first = t_light < hit.t
    mesh_hit = active & hit.mask & ~light_first
    light_hit = active & light_first
    miss = active & ~hit.mask & ~light_first

    # Miss: the environment map, MIS-weighted against the previous BSDF
    # sample (SimpleRGPs.cu:349-362), or the background tint.
    if scene.environment is not None:
        env_radiance = environment_evaluate(scene.environment, direction)
        env_pdf = environment_pdf(scene.environment, direction)
        w = torch.where(bsdf_pdf > 0.0, mis_weight(bsdf_pdf, env_pdf), 1.0)
        env_radiance = env_radiance * w[..., None]
    else:
        env_radiance = scene.environment_tint
    radiance = radiance + torch.where(
        miss[..., None], throughput * env_radiance, 0.0)

    # Analytic light hit, MIS-weighted against the previous BSDF sample.
    if scene.lights.count > 0:
        li = torch.clamp_min(light_idx, 0)
        l_radiance = evaluate_light(scene.lights, li, origin, direction)
        l_pdf = light_pdf(scene.lights, li, origin, direction)
        w = torch.where(bsdf_pdf > 0.0, mis_weight(bsdf_pdf, l_pdf), 1.0)
        clamped_t = minimum(throughput, settings.firefly_clamp)
        radiance = radiance + torch.where(
            light_hit[..., None], clamped_t * l_radiance * w[..., None], 0.0)

    # Mesh hit: attributes and material.
    prim = torch.clamp_min(hit.prim, 0)
    v, n, uv, tr, mat_idx = _fetch_tri_attributes(scene, prim)
    bary = torch.stack([1.0 - hit.u - hit.v, hit.u, hit.v], dim=-1)
    position = _interpolate(bary, v)
    shading_normal = normalize(_interpolate(bary, n))
    tr_scale = _interpolate(bary, tr)
    face = cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    geo_normal = normalize(face)

    mats = scene.materials.gather(mat_idx)
    # Ray footprint in uv units for trilinear mip selection (Texture.h
    # Trilinear): per-triangle texel density × the pixel's world-space
    # width at the hit, spread by the incidence angle (capped at 20:1).
    # Bounces reuse the segment-distance formula.
    footprint_uv = None
    if settings.trilinear_textures and pixel_angle is not None:
        world_area = 0.5 * torch.linalg.vector_norm(face, dim=-1)
        uv1 = uv[:, 1] - uv[:, 0]
        uv2 = uv[:, 2] - uv[:, 0]
        uv_area = 0.5 * absolute(uv1[:, 0] * uv2[:, 1] - uv1[:, 1] * uv2[:, 0])
        density = torch.sqrt(uv_area / maximum(world_area, 1e-20))
        t_safe = torch.where(hit.mask, hit.t, 0.0)
        spread = maximum(absolute(dot(geo_normal, direction)), 0.05)
        footprint_uv = density * t_safe * pixel_angle / spread
    tint, roughness, metallic, coverage = _surface_material_params(
        scene, mats, _interpolate(bary, uv), tr_scale, footprint_uv,
        settings.trilinear_textures)

    # Cutouts are implicitly thin-walled (Types.h:384); a Transmissive
    # material's back face is its inside and is never culled.
    thin_walled = (mats.flags & (FLAG_THIN_WALLED | FLAG_CUTOUT)) != 0
    transmissive_model = mats.shading_model == SHADING_TRANSMISSIVE
    hit_from_front = dot(geo_normal, direction) < 0.0
    backside_cull = ~hit_from_front & ~thin_walled & ~transmissive_model

    # Coverage: stochastic transparency (MonteCarlo.cu:152-164).
    u_bsdf4 = path_rng_4d(accumulation, pixel_hash,
                          bounce * Dimension.PER_BOUNCE + Dimension.BSDF)
    discard_coverage = coverage < u_bsdf4[..., 3]
    passthrough = mesh_hit & (backside_cull | discard_coverage)
    shade = mesh_hit & ~backside_cull & ~discard_coverage

    front = hit_from_front[..., None]
    geo_normal = torch.where(front, geo_normal, -geo_normal)
    sn = torch.where(front, shading_normal, -shading_normal)
    sn = _fix_backfacing_shading_normal(-direction, sn)

    wo = to_local(-direction, sn)
    cos_theta_o = torch.where(hit_from_front | thin_walled, wo[..., 2],
                              -wo[..., 2])

    # Path regularization (MonteCarlo.cu:239-244): no floor after a delta
    # bounce, on the primary one, or where the last pdf disabled MIS.
    min_roughness = None
    if settings.path_regularization_scale > 0.0:
        scale = _regularization_scale(settings, accumulation)
        min_alpha = estimate_ggx_alpha_from_max_pdf(
            absolute(cos_theta_o), maximum(bsdf_pdf * scale, 1e-3))
        min_roughness = torch.where(bsdf_was_delta | (bsdf_pdf <= 0.0), 0.0,
                                    roughness_from_alpha(min_alpha))
    bundle = _create_shading(
        scene.shading_models, mats.shading_model, tint, roughness,
        mats.specularity, metallic, mats.coat, mats.coat_roughness,
        cos_theta_o, thin_walled, min_roughness)

    # Surface emission.
    radiance = radiance + torch.where(shade[..., None],
                                      throughput * mats.emission, 0.0)

    # NEE with RIS, then one binary any-hit shadow query or the march
    # through semi-transparent surfaces.
    u_nee = path_rng_4d(accumulation, pixel_hash,
                        bounce * Dimension.PER_BOUNCE + Dimension.NEE)
    l_dir, l_dist, l_radiance, nee_valid = _reestimated_light_samples(
        scene.lights, bundle, position, wo, sn, u_nee,
        settings.next_event_sample_count, settings.delta_light_clamp,
        _environment_sampler(scene, settings))
    l_radiance = l_radiance * throughput
    shadow_side = torch.where(dot(l_dir, geo_normal) >= 0, 1.0, -1.0)
    shadow_origin = offset_ray_origin(position, geo_normal * shadow_side[..., None])
    has_light = shade & (torch.amax(l_radiance, dim=-1) > 0.0)
    if replay is not None:
        shadow_trans = replay.shadow_trans
    elif settings.coverage_aware_shadows:
        with torch.no_grad():
            shadow_trans = _shadow_transmittance(
                scene, shadow_origin.detach(), l_dir.detach(),
                l_dist.detach() * (1.0 - 1e-4), eps,
                settings.shadow_coverage_steps)
    else:
        occluded = _scene_query(intersect_scene_any, scene, shadow_origin,
                                l_dir, eps, l_dist * (1.0 - 1e-4),
                                live_count=live_count)
        shadow_trans = torch.where(occluded, 0.0, 1.0)
    radiance = radiance + torch.where(
        has_light[..., None], l_radiance * shadow_trans[..., None], 0.0)

    # BSDF sampling; mirror directions that point into the geometry
    # (MonteCarlo.cu:204-228).
    s = bundle.sample(wo, u_bsdf4[..., :3])
    new_dir = to_world(s.direction, sn)
    is_reflection = s.direction[..., 2] >= 0.0
    cos_geo = dot(new_dir, geo_normal)
    wrong_side = torch.where(is_reflection, cos_geo < 0.0, cos_geo >= 0.0)
    new_dir = torch.where(wrong_side[..., None], reflect(new_dir, geo_normal),
                          new_dir)

    weight = torch.abs(s.direction[..., 2]) / maximum(s.pdf, 1e-12)
    new_throughput = torch.where((s.pdf > 0.0)[..., None],
                                 throughput * s.reflectance * weight[..., None],
                                 0.0)
    bounce_side = torch.where(dot(new_dir, geo_normal) >= 0, 1.0, -1.0)
    new_origin = offset_ray_origin(position, geo_normal * bounce_side[..., None])
    new_bsdf_pdf = torch.where(s.is_delta | ~nee_valid, 0.0, s.pdf)
    # Passthrough lanes continue past the surface on the far side.
    pass_origin = offset_ray_origin(position, -geo_normal)

    shade_c = shade[..., None]
    origin = torch.where(shade_c, new_origin,
                         torch.where(passthrough[..., None], pass_origin, origin))
    direction = torch.where(shade_c, new_dir, direction)
    throughput = torch.where(shade_c, new_throughput, throughput)
    bsdf_pdf = torch.where(shade, new_bsdf_pdf, bsdf_pdf)
    bsdf_was_delta = torch.where(shade, s.is_delta, bsdf_was_delta)
    bounce = torch.where(shade, bounce + 1, bounce)
    active = (active & ~miss & ~light_hit
              & (~shade | (torch.amax(throughput, dim=-1) > 0.0))
              & (bounce <= settings.max_bounce_count))
    new_state = _PathState(origin, direction, throughput, radiance, bsdf_pdf,
                           bsdf_was_delta, pixel_hash, bounce, active)
    if record:
        return new_state, _HitRecords(hit.t, hit.prim, hit.u, hit.v,
                                      shadow_trans)
    return new_state


def _regularization_scale(settings: RenderSettings, accumulation: int) -> float:
    """scale · (1 + decay · accumulation), rounded as JAX's float32 0-d
    arithmetic rounds it (every operand float32)."""
    f32 = np.float32
    return float(f32(settings.path_regularization_scale) * (
        f32(1.0) + f32(settings.path_regularization_decay) * f32(accumulation)))


# -- entry points ---------------------------------------------------------------

def _camera_pixel_angle(camera: PinholeCamera, height: int):
    """Vertical angular size of one pixel, fov_y / height with fov_y =
    2·atan(1 / proj[1, 1]): what sets the ray footprint of trilinear mip
    selection (a 0-d tensor on the camera's device)."""
    f = camera.projection[1, 1]
    return 2.0 * torch.atan(1.0 / maximum(f, 1e-6)) / height


def _camera_lanes(camera: PinholeCamera, x, y, width: int, height: int,
                  accumulation: int, valid) -> _PathState:
    """Fresh camera-ray lanes for int64 pixel coords x/y [r]."""
    pixel_hash, _ = pcg2d(x, y)
    xf = x.to(torch.float32)
    yf = y.to(torch.float32)
    if accumulation == 0:
        xf = xf + 0.5
        yf = yf + 0.5
    else:
        u_cam = path_rng_4d(accumulation, pixel_hash, Dimension.CAMERA)
        xf = xf + u_cam[..., 0]
        yf = yf + u_cam[..., 1]
    origin, direction = camera_ray_directions(
        camera, torch.stack([xf / width, 1.0 - yf / height], dim=-1))
    r = x.shape[0]
    device = x.device
    return _PathState(
        origin=origin,
        direction=direction,
        throughput=torch.ones((r, 3), device=device),
        radiance=torch.zeros((r, 3), device=device),
        bsdf_pdf=torch.zeros(r, device=device),
        bsdf_was_delta=torch.ones(r, dtype=torch.bool, device=device),
        pixel_hash=pixel_hash,
        bounce=torch.zeros(r, dtype=torch.int64, device=device),
        active=valid & torch.isfinite(origin[..., 0]))


def _iterations(settings: RenderSettings) -> int:
    """Iterations of the fixed-iteration wavefront: bounces + slack for
    passthrough lanes (each iteration is one shade or one passthrough)."""
    return settings.max_bounce_count + 1 + settings.passthrough_slack


def _pixel_lane_state(camera: PinholeCamera, x, y, width: int,
                      accumulation: int, height: int):
    """Camera-ray lanes for integer pixel coords x/y [...] → (_PathState
    over the flattened pixels, the pixels' shape)."""
    shape = tuple(x.shape)
    x = x.reshape(-1).to(torch.int64)
    y = y.reshape(-1).to(torch.int64)
    return _camera_lanes(camera, x, y, width, height, accumulation,
                         torch.ones_like(x, dtype=torch.bool)), shape


def _step(step, state: _PathState, remat: bool) -> _PathState:
    """``step(state)``; with ``remat`` and autograd recording, under
    ``torch.utils.checkpoint``: the backward recomputes the iteration (its
    traces included) instead of keeping its intermediates."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(
            step, state, use_reentrant=False, preserve_rng_state=False)
    return step(state)


def render_sample_pixels(scene: RenderScene, camera: PinholeCamera, x, y,
                         width: int, height: int, accumulation: int,
                         settings: RenderSettings = RenderSettings()):
    """One progressive sample for integer pixel coords x/y [...] →
    radiance [..., 3]: pixel indices are data, as in the SmallPT
    integrator. ``settings.remat_bounces`` recomputes each iteration in the
    backward; ``settings.detached_replay_vjp`` takes the backward from
    :func:`render_sample_pixels_detached`."""
    accumulation = int(accumulation)
    if settings.detached_replay_vjp and torch.is_grad_enabled():
        return render_sample_pixels_detached(scene, camera, x, y, width,
                                             height, accumulation, settings)
    state, shape = _pixel_lane_state(camera, x, y, width, accumulation,
                                     height)
    step = functools.partial(_wavefront_step, scene, settings, accumulation,
                             pixel_angle=_camera_pixel_angle(camera, height))
    for _ in range(_iterations(settings)):
        state = _step(step, state, settings.remat_bounces)
    return state.radiance.reshape(shape + (3,))


class _DetachedReplay(torch.autograd.Function):
    """The detached-replay VJP of :func:`render_sample_pixels_detached`.
    ``run`` holds everything but the tensors: the (scene, camera) rebuild,
    pixels, sizes, accumulation and settings; ``leaves`` are the tensors of
    (scene, camera)."""

    @staticmethod
    def forward(ctx, run, *leaves):
        scene, camera = run["unflatten"](leaves)
        settings, accumulation = run["settings"], run["accumulation"]
        state, shape = _pixel_lane_state(camera, run["x"], run["y"],
                                         run["width"], accumulation,
                                         run["height"])
        pixel_angle = _camera_pixel_angle(camera, run["height"])
        records = []
        for _ in range(_iterations(settings)):
            state, rec = _wavefront_step(scene, settings, accumulation, state,
                                         pixel_angle=pixel_angle, record=True)
            records.append(rec)
        ctx.run, ctx.records = run, records
        ctx.save_for_backward(*leaves)
        return state.radiance.reshape(shape + (3,))

    @staticmethod
    def backward(ctx, grad):
        run, wants = ctx.run, ctx.needs_input_grad[1:]
        settings, accumulation = run["settings"], run["accumulation"]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(want)
                      for t, want in zip(ctx.saved_tensors, wants)]
            scene, camera = run["unflatten"](leaves)
            state, shape = _pixel_lane_state(camera, run["x"], run["y"],
                                             run["width"], accumulation,
                                             run["height"])
            pixel_angle = _camera_pixel_angle(camera, run["height"])
            for rec in ctx.records:
                step = functools.partial(_wavefront_step, scene, settings,
                                         accumulation, pixel_angle=pixel_angle,
                                         replay=rec)
                state = _step(step, state, settings.remat_bounces)
            wanted = [t for t, want in zip(leaves, wants) if want]
            grads = iter(torch.autograd.grad(
                state.radiance.reshape(shape + (3,)), wanted, grad,
                allow_unused=True))
        return (None, *(next(grads) if want else None for want in wants))


def render_sample_pixels_detached(scene: RenderScene, camera: PinholeCamera,
                                  x, y, width: int, height: int,
                                  accumulation: int,
                                  settings: RenderSettings = RenderSettings()):
    """:func:`render_sample_pixels` under the detached-replay VJP.

    Forward: the wavefront as usual, under ``no_grad``, keeping each
    iteration's _HitRecords (five numbers a lane an iteration: the only
    scene-query results, detached in plain reverse mode too). Backward:
    autograd through a replay of the estimator driven by those records —
    attribute fetch, shading, RIS NEE and the reparameterized sampling
    transforms are recomputed, no ray is traced — with ``remat_bounces``
    checkpointing each replayed iteration. The gradients are plain reverse
    mode's; the camera and the pixels get none (zero cotangents)."""
    leaves, unflatten = tree_flatten((scene, camera))
    run = dict(unflatten=unflatten, x=x, y=y, width=width, height=height,
               accumulation=int(accumulation), settings=settings)
    return _DetachedReplay.apply(run, *leaves)


def render_sample(scene: RenderScene, camera: PinholeCamera, width: int,
                  height: int, accumulation: int,
                  settings: RenderSettings = RenderSettings()):
    """One progressive frame through the fixed-iteration wavefront →
    radiance [height, width, 3] (row 0 = top)."""
    device = scene.tri_verts.device
    y, x = torch.meshgrid(torch.arange(height, device=device),
                          torch.arange(width, device=device), indexing="ij")
    return render_sample_pixels(scene, camera, x, y, width, height,
                                accumulation, settings)


def render_rays(scene: RenderScene, origin, direction, pixel_hash,
                accumulation: int,
                settings: RenderSettings = RenderSettings()):
    """Trace explicit rays [r, 3] through the full estimator → radiance
    [r, 3]: the ray-level entry the edge-sampled geometry gradients probe
    with (their probes need exact sub-pixel viewport positions).
    ``pixel_hash`` (an int or an integer tensor [r]) keys the Sobol chains,
    so probe pairs passing the same hash share their noise."""
    accumulation = int(accumulation)
    r = origin.shape[0]
    device = origin.device
    state = _PathState(
        origin=origin,
        direction=direction,
        throughput=torch.ones((r, 3), device=device),
        radiance=torch.zeros((r, 3), device=device),
        bsdf_pdf=torch.zeros(r, device=device),
        bsdf_was_delta=torch.ones(r, dtype=torch.bool, device=device),
        pixel_hash=torch.broadcast_to(
            torch.as_tensor(pixel_hash, dtype=torch.int64, device=device),
            (r,)),
        bounce=torch.zeros(r, dtype=torch.int64, device=device),
        active=torch.isfinite(origin[..., 0]))
    for _ in range(_iterations(settings)):
        state = _wavefront_step(scene, settings, accumulation, state)
    return state.radiance


def _make_camera_lanes(camera: PinholeCamera, pixel_idx, width: int,
                       height: int, accumulation: int, pixel_end=None):
    """Lanes for flat pixel indices [r] (>= ``pixel_end``, by default
    width·height, = idle lane). A sharded render passes the end of its own
    pixel range; an index past the frame renders the frame's last pixel."""
    n_pixels = width * height
    if pixel_end is None:
        pixel_end = n_pixels
    safe_idx = torch.clamp_max(pixel_idx, n_pixels - 1)
    return _camera_lanes(camera, safe_idx % width, safe_idx // width, width,
                         height, accumulation, pixel_idx < pixel_end)


def pool_sort_order(origin, direction, active, lo, hi):
    """The pool's coherence order → int64 [r] permutation: origin Morton
    code (6 bits per axis inside the scene box lo..hi) and direction
    octant, inactive lanes last. The sort is stable, so equal keys keep
    their pool order and the live prefix is the same on every backend."""
    from bifrost3d_tpu_torch.geometry.pallas_bvh import coherence_sort_key
    key = coherence_sort_key(origin, direction, lo, hi)
    key = key + torch.where(active, 0, 1 << 22)
    return torch.argsort(key, stable=True)


def _sorted_pool(scene: RenderScene, state: _PathState, pixel_idx):
    """Sort the pool before a step: keeps the BVH kernel's neighbouring
    threads spatially and directionally coherent after bounces scatter the
    ray origins, and makes the live lanes a prefix the kernel can stop
    at."""
    if scene.bvh is None:
        raise ValueError("sort_rays_every needs a scene that carries its BVH")
    order = pool_sort_order(state.origin, state.direction, state.active,
                            scene.bvh.node_min[0], scene.bvh.node_max[0])
    return _PathState(*(f[order] for f in state)), pixel_idx[order]


def render_pixels_pooled(scene: RenderScene, camera: PinholeCamera,
                         width: int, height: int, accumulation: int,
                         settings: RenderSettings = RenderSettings(),
                         pool_size: int = 65536, pixel_start: int = 0,
                         n_pixels: int | None = None,
                         with_iters: bool = False):
    """Pooled wavefront over the flat pixel range [pixel_start,
    pixel_start + n_pixels) (by default the whole frame) → (radiance
    [n_pixels, 3], ray count [] int64[, wavefront steps]).

    A pool of ``pool_size`` lanes runs the wavefront step; finished lanes
    add their radiance into the range and are refilled with fresh camera
    rays from its remaining pixels, so every trace runs near full
    occupancy. The ray count is live lanes × 2 (closest + shadow) per
    iteration. A sharded render (``parallel/render.py``) gives each shard
    its own range: every pixel's lanes are the ones the whole frame would
    give it, so the ranges of a frame put together are that frame.
    """
    accumulation = int(accumulation)
    device = scene.tri_verts.device
    if n_pixels is None:
        n_pixels = width * height
    pixel_start = int(pixel_start)
    pixel_end = pixel_start + n_pixels
    r = min(pool_size, n_pixels)

    pixel_idx = pixel_start + torch.arange(r, dtype=torch.int64, device=device)
    state = _make_camera_lanes(camera, pixel_idx, width, height, accumulation,
                               pixel_end)
    accum = torch.zeros((n_pixels, 3), device=device)
    pixel_angle = _camera_pixel_angle(camera, height)
    next_pixel = torch.tensor(pixel_start + r, dtype=torch.int64,
                              device=device)
    rays = torch.zeros((), dtype=torch.int64, device=device)

    # Safety bound against pathological passthrough chains.
    max_iters = (n_pixels // r + 1) * _iterations(settings) * 4 + 64
    it = 0
    while it < max_iters:
        # The loop condition: one host sync per iteration.
        if not bool((state.active.any() | (next_pixel < pixel_end)).item()):
            break
        if settings.sort_rays_every and it % settings.sort_rays_every == 0:
            state, pixel_idx = _sorted_pool(scene, state, pixel_idx)
        n_active = state.active.sum()
        # The live lanes are a prefix only when the pool was sorted in this
        # very iteration; the trace kernels read the count on the device.
        live = n_active if settings.sort_rays_every == 1 else None
        rays = rays + 2 * n_active
        state = _wavefront_step(scene, settings, accumulation, state,
                                pixel_angle=pixel_angle, live_count=live)
        done = (pixel_idx < pixel_end) & ~state.active

        # Each pixel finishes once per pass: add finished lanes into the
        # range (in place; idle lanes add zeros).
        accum.index_add_(
            0, torch.clamp(pixel_idx - pixel_start, 0, n_pixels - 1),
            torch.where(done[..., None], state.radiance, 0.0))

        # Refill: hand each finished lane the next unstarted pixel.
        slot = torch.cumsum(done.to(torch.int64), dim=0) - 1
        new_idx = next_pixel + slot
        refill = done & (new_idx < pixel_end)
        pixel_idx = torch.where(refill, new_idx,
                                torch.where(done, pixel_end, pixel_idx))
        next_pixel = torch.clamp_max(next_pixel + done.sum(), pixel_end)

        fresh = _make_camera_lanes(camera, pixel_idx, width, height,
                                   accumulation, pixel_end)
        state = _PathState(*(
            torch.where(refill.reshape(refill.shape + (1,) * (f.dim() - 1)), f, s)
            for f, s in zip(fresh, state)))
        it += 1
    if with_iters:
        return accum, rays, it
    return accum, rays


def render_sample_pooled(scene: RenderScene, camera: PinholeCamera,
                         width: int, height: int, accumulation: int,
                         settings: RenderSettings = RenderSettings(),
                         pool_size: int = 65536):
    """One progressive frame through the pooled wavefront → [h, w, 3]."""
    accum, _ = render_pixels_pooled(scene, camera, width, height,
                                    accumulation, settings, pool_size)
    return accum.reshape(height, width, 3)


def render_sample_pooled_counted(scene: RenderScene, camera: PinholeCamera,
                                 width: int, height: int, accumulation: int,
                                 settings: RenderSettings = RenderSettings(),
                                 pool_size: int = 65536):
    """Like :func:`render_sample_pooled`, plus the in-run ray count."""
    accum, rays = render_pixels_pooled(scene, camera, width, height,
                                       accumulation, settings, pool_size)
    return accum.reshape(height, width, 3), rays


_EXPLAINED_PATHS = set()


def _device_kind(scene: RenderScene) -> str:
    """The type of the device the scene's tensors live on ("cuda", "cpu")."""
    return scene.tri_verts.device.type


def explain_render_path(scene: RenderScene,
                        settings: RenderSettings = RenderSettings()) -> str:
    """Which forward path :func:`render_sample_fast` takes, and why:
    ``"megakernel"``, above ``MAX_TRIS`` triangles ``"megakernel (hier:
    cluster-BVH DMA trace)"`` (the JAX package's words for its BVH
    branch), or ``"wavefront: <reasons>"``; a scene that carries
    the BVH packing says ``"wavefront [BVH trace, pool sorted every n
    step(s)]: <reasons>"`` (or ``pool not sorted``), one that carries the
    resident-cluster or the cluster-scan packing names that trace
    instead."""
    from bifrost3d_tpu_torch.integrator.pallas_mesh import (
        MAX_TRIS, megakernel_ineligibility_reasons)
    reasons = megakernel_ineligibility_reasons(scene, settings)
    kind = _device_kind(scene)
    if kind != "cuda":
        reasons = [f"device is {kind}, not cuda"] + reasons
    if not reasons:
        if int(scene.tri_verts.shape[0]) > MAX_TRIS:
            return "megakernel (hier: cluster-BVH DMA trace)"
        return "megakernel"
    trace = ""
    if scene.tri_clustered is not None:
        every = settings.sort_rays_every
        kind = {"VmemTriangles": "resident-cluster",
                "ClusteredTriangles": "cluster-scan"}.get(
                    type(scene.tri_clustered).__name__, "BVH")
        trace = (f" [{kind} trace, pool sorted every {every} step(s)]"
                 if every else f" [{kind} trace, pool not sorted]")
    return "wavefront" + trace + ": " + ", ".join(reasons)


def _takes_megakernel(scene: RenderScene, settings: RenderSettings) -> bool:
    """Whether the scene renders through the mesh megakernel: it is on a
    CUDA card and megakernel-eligible. The chosen path, with the reasons
    against the megakernel, is logged at INFO once per scene identity
    (:func:`explain_render_path`)."""
    from bifrost3d_tpu_torch.integrator import pallas_mesh
    mega = (_device_kind(scene) == "cuda"
            and pallas_mesh.mesh_megakernel_eligible(scene, settings))
    key = (id(scene.tri_verts), id(scene.materials.tint), mega)
    if key not in _EXPLAINED_PATHS:
        if len(_EXPLAINED_PATHS) > 256:
            _EXPLAINED_PATHS.clear()
        _EXPLAINED_PATHS.add(key)
        logger.info("render path: %s", explain_render_path(scene, settings))
    return mega


def render_sample_fast(scene: RenderScene, camera: PinholeCamera,
                       width: int, height: int, accumulation: int,
                       settings: RenderSettings = RenderSettings(),
                       pool_size: int = 65536):
    """The product dispatch:

    - scene on a CUDA card and megakernel-eligible → the mesh megakernel
      (``csrc/mesh_megakernel.cu``): the whole path in one launch;
    - otherwise → the pooled compacting wavefront.

    The chosen path, with the reasons against the megakernel, is logged
    at INFO once per scene identity (:func:`explain_render_path`).
    """
    if _takes_megakernel(scene, settings):
        from bifrost3d_tpu_torch.integrator import pallas_mesh
        img, _ = pallas_mesh.render_mesh_megakernel(
            scene, camera, width, height, accumulation, settings,
            sum_rays=False)
        return img
    return render_sample_pooled(scene, camera, width, height, accumulation,
                                settings, pool_size)


def render_progressive(scene: RenderScene, camera: PinholeCamera,
                       width: int, height: int, accumulations: int,
                       settings: RenderSettings = RenderSettings(),
                       pool_size: int = 65536,
                       high_precision: bool = False):
    """Progressive accumulation (lerp 1/(n+1), SimpleRGPs.cu:74-107).

    ``high_precision`` keeps the running sum in Kahan-compensated float32
    (a (sum, compensation) pair) and divides once at the end — the
    counterpart of the reference's double-precision accumulation buffer.
    Each sample renders through :func:`render_sample_fast`, except where
    that takes the mesh megakernel and the running mean is plain float32:
    there the launch is prepared once and the kernel lerps each sample into
    the running mean in place (``pallas_mesh.MegakernelAccumulator``, one
    launch an accumulation), bit for bit the same result. Under a
    ``torch.profiler`` session the call is span ``b3d.render.progressive``
    and each accumulation, its frame and its lerp (or Kahan step),
    ``b3d.render.frame``.
    """
    device = scene.tri_verts.device
    with span("render.progressive"):
        if high_precision:
            total = torch.zeros((height, width, 3), device=device)
            comp = torch.zeros((height, width, 3), device=device)
            for n in range(accumulations):
                with span("render.frame"):
                    frame = render_sample_fast(scene, camera, width, height,
                                               n, settings, pool_size)
                    y = frame - comp
                    t = total + y
                    comp = (t - total) - y
                    total = t
            return total / max(accumulations, 1)
        buffer = torch.zeros((height, width, 3), device=device)
        # The lerp in the kernel is the card's: where the megakernel's
        # dispatch meets a CPU scene (the CPU tests drive it so, with the
        # device kind patched), render_mesh_megakernel takes its plain
        # version and torch lerps.
        if buffer.is_cuda and _takes_megakernel(scene, settings):
            from bifrost3d_tpu_torch.integrator.pallas_mesh import (
                MegakernelAccumulator)
            accumulator = MegakernelAccumulator(scene, camera, width, height,
                                                settings, buffer)
            for n in range(accumulations):
                with span("render.frame"):
                    accumulator.accumulate(n)
            return buffer
        for n in range(accumulations):
            with span("render.frame"):
                frame = render_sample_fast(scene, camera, width, height, n,
                                           settings, pool_size)
                buffer = buffer + (frame - buffer) / (n + 1)
        return buffer
