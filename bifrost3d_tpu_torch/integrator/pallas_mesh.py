"""The mesh path tracer as one CUDA megakernel: scenes of up to 262,144
triangles, one kernel launch per frame.

Port of ``bifrost3d_tpu/integrator/pallas_mesh.py`` (``MAX_TRIS``,
``HIER_MAX_TRIS``, ``MAX_MATERIALS``, ``MAX_LIGHTS``, ``ATTR_ROWS``,
``MAX_TEX_TEXELS``, ``MAX_ENV_TEXELS``, ``MAX_ENV_PDF``, ``MAX_ENV_POOL``,
``megakernel_ineligibility_reasons``, ``mesh_megakernel_eligible``,
``_pack_scene``, ``_pack_env``, ``_pack_textures``, ``_live_tables``,
``_static_info``, ``prewarm_megakernel``, ``_rho_tables``,
``render_mesh_megakernel`` with ``_render_packed``): its
dense branch (at most ``MAX_TRIS`` triangles) and its BVH branch
(``_hier_tracers``, above that). The TPU kernel ``_make_kernel`` becomes
the hand-written CUDA kernel ``csrc/mesh_megakernel.cu``: one thread per
pixel runs the whole progressive sample — the trace (dense Möller–Trumbore
over the scene's triangles in shared memory, or above ``MAX_TRIS`` a
per-thread walk of the port's own triangle BVH,
``geometry/pallas_bvh.py::HierTriangles``, in global memory), attribute
fetch by triangle index (dense) or by slot of the tree's leaf order (BVH),
Default (EON + GGX, optional coat) or Diffuse shading, RIS(≤ 8) NEE with
MIS over sphere, spot and directional lights and the environment's
presampled pool, a binary any-hit shadow ray or the coverage-aware march of
closest hits, emission, the background tint or the environment map
(bilinear latlong fetch with MIS), NEAREST tint-roughness and coverage
textures, cutouts and stochastic coverage, passthrough of back faces and
discarded hits, and the Owen-scrambled Sobol RNG — with the path state in
registers.

:func:`render_mesh_megakernel` dispatches on the scene's device: CUDA
tensors launch the kernel, CPU tensors take the plain PyTorch version
:func:`mesh_megakernel_reference`, anything else raises. A failed build or
launch raises; nothing falls back. ``launch_count`` counts kernel launches,
``accumulate_count`` the accumulations lerped into a running mean in the
kernel (:class:`MegakernelAccumulator`).

A frame on the card is one launch: each thread makes its own camera lane
(pixel, pcg2d hash, Sobol jitter, ray through the camera's matrices) and
writes its pixel in raster order; on the BVH branch a warp's 32 threads
cover one small 2-D pixel tile (``HIER_PIXEL_TILE``), so that its rays stay
close in the tree. The dense trace skips chunks of 32 triangles whose
padded box the ray misses or enters beyond its best hit. The plain version
takes the lanes made in torch (:func:`megakernel_inputs`). Every table a
frame reads is cached per (identity, version) of the scene tensors it comes
from, and so is the eligibility verdict: after a scene's first frame a
frame reads nothing back from the card. The progressive loop prepares the
launch once a render (:class:`MegakernelAccumulator`), and the kernel lerps
each accumulation into the running mean in place: an accumulation is one
launch.

A scene with an environment map, a bound texture, a cutout or
coverage-aware shadows launches the kernel's ``kExtras`` instantiation (one
per trace); every other scene launches the instantiation it launched before
those branches existed. Texels, the map, its pdf grid and the pool are plain
records in global memory (``KernelExtras``), indexed with integers.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from bifrost3d_tpu_torch.geometry.bvh import STACK_SIZE
from bifrost3d_tpu_torch.geometry.pallas_bvh import (
    HierTriangles,
    hierarchical_intersect_reference,
    pack_hierarchical,
)
# The dense trace's cull (CHUNK, CHUNK_PAD, chunk_boxes and its plain
# version) is the trace kernels' own, in csrc/dense_trace.cuh; its names
# stay in this namespace.
from bifrost3d_tpu_torch.geometry.pallas_intersect import (  # noqa: F401
    CHUNK,
    CHUNK_PAD,
    _check,
    _finish,
    chunk_boxes,
    culled_dense_intersect_reference,
    dense_intersect_reference,
)
from bifrost3d_tpu_torch.geometry.traverse import Hit, ray_bounds
from bifrost3d_tpu_torch.integrator.path_tracer import (
    RenderSettings,
    _camera_lanes,
    _create_shading,
    _fix_backfacing_shading_normal,
    _reestimated_light_samples,
    _reverse_halton_offsets,
    mis_weight,
)
from bifrost3d_tpu_torch.io.texture import FILTER_NONE, WRAP_REPEAT
from bifrost3d_tpu_torch.lights.analytic import evaluate_light, light_pdf
from bifrost3d_tpu_torch.lights.environment import (
    EnvironmentLight,
    PresampledEnvironmentLight,
    environment_evaluate,
    environment_pdf,
    presampled_environment_sample,
)
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
from bifrost3d_tpu_torch.scene.camera import PinholeCamera
from bifrost3d_tpu_torch.scene.materials import (
    FLAG_CUTOUT,
    SHADING_DEFAULT,
    SHADING_DIFFUSE,
    SHADING_TRANSMISSIVE,
)
from bifrost3d_tpu_torch.scene.render_scene import RenderScene
from bifrost3d_tpu_torch.shading.fittings import get_fittings
from bifrost3d_tpu_torch.utils.profiling import span
from bifrost3d_tpu_torch.utils.versioned import VersionedCache

MAX_TRIS = 1024
MAX_MATERIALS = 32
MAX_LIGHTS = 8
MAX_RIS = 8
ATTR_ROWS = 24            # attr table rows (19 used; padded to 8-multiple)
HIER_MAX_TRIS = 262144    # the BVH branch's cap
MAX_TEX_TEXELS = 4096     # level-0 texels of the whole bank
MAX_ENV_TEXELS = 4096     # latlong radiance map budget (h*w)
MAX_ENV_PDF = 8192        # pdf grid budget (ph*pw)
MAX_ENV_POOL = 8192       # presampled pool entries
# Pixels per warp on the BVH branch, (width, height) of the tile a warp's 32
# lanes cover; None = raster order.
HIER_PIXEL_TILE = (8, 4)
_BIG = 3.0e38
_THREADS = 128            # the kernel's block size, one pixel per thread

launch_count = 0
accumulate_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


# -- eligibility -----------------------------------------------------------------

def megakernel_ineligibility_reasons(scene: RenderScene,
                                     settings: RenderSettings) -> list:
    """Every feature of this scene/settings combination outside the
    kernel's scope, as readable strings (empty = eligible): the JAX
    package's reasons, word for word."""
    reasons = []
    t = int(scene.tri_verts.shape[0])
    if t == 0:
        reasons.append("empty scene")
    elif t > HIER_MAX_TRIS:
        reasons.append(f"{t} triangles > HIER_MAX_TRIS {HIER_MAX_TRIS}")
    if scene.environment is not None:
        env = scene.environment
        h, w = int(env.image.shape[0]), int(env.image.shape[1])
        if h * w > MAX_ENV_TEXELS:
            reasons.append(f"environment map {h}x{w} > MAX_ENV_TEXELS "
                           f"{MAX_ENV_TEXELS}")
        ph, pw = env.pdf_size
        if int(ph) * int(pw) > MAX_ENV_PDF:
            reasons.append(f"environment pdf grid {ph}x{pw} > "
                           f"MAX_ENV_PDF {MAX_ENV_PDF}")
        pool = scene.environment_presampled
        if pool is None:
            reasons.append("environment without presampled pool "
                           "(build_render_scene presample_environment)")
        elif pool.sample_count > MAX_ENV_POOL:
            reasons.append(f"environment pool {pool.sample_count} > "
                           f"MAX_ENV_POOL {MAX_ENV_POOL}")
        if not settings.use_presampled_environment:
            reasons.append("CDF-search environment NEE "
                           "(use_presampled_environment=False)")
    mats = scene.materials
    m = int(mats.shading_model.shape[0])
    if m == 0 or m > MAX_MATERIALS:
        reasons.append(f"{m} materials outside [1, {MAX_MATERIALS}]")
    if SHADING_TRANSMISSIVE in scene.shading_models:
        reasons.append("Transmissive shading model")
    if bool(torch.any(mats.metallic_texture >= 0)):
        reasons.append("metallic textures")
    # Tint-roughness and coverage textures are in scope when the bank's
    # level-0 texels fit the budget and every bound texture is NEAREST (the
    # procedural checkers and cutout grids of Opacity.h / Utils.cpp).
    bound = set()
    for slot in (mats.tint_roughness_texture, mats.coverage_texture):
        bound |= {int(b) for b in slot.tolist() if b >= 0}
    if bound:
        bank = scene.textures
        if bank is None or bank.count == 0:
            reasons.append("texture bindings without a texture bank")
        else:
            sizes = bank.sizes.cpu().numpy()
            total = int((sizes[:, 0] * sizes[:, 1]).sum())
            if total > MAX_TEX_TEXELS:
                reasons.append(
                    f"{total} texels > MAX_TEX_TEXELS {MAX_TEX_TEXELS}")
            filters = bank.filters.tolist()
            if any(int(filters[b]) != FILTER_NONE for b in bound):
                reasons.append("non-nearest texture filtering")
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


def _fields(obj) -> tuple:
    """The tensor fields of a NamedTuple (nested ones left out); () for
    None."""
    return () if obj is None else tuple(
        f for f in obj if isinstance(f, torch.Tensor))


def _scene_sources(scene: RenderScene) -> tuple:
    """Every scene tensor that the eligibility check or a frame's tables
    read: the keys of the per-frame caches."""
    return ((scene.tri_verts, scene.tri_normals_oct, scene.tri_uvs,
             scene.tri_tint_roughness, scene.tri_material,
             scene.environment_tint, scene.scene_epsilon)
            + _fields(scene.materials) + _fields(scene.lights)
            + _fields(scene.bvh) + _fields(scene.tri_clustered)
            + _fields(scene.environment)
            + _fields(scene.environment_presampled)
            + _fields(scene.textures))


def _scene_shape(scene: RenderScene) -> tuple:
    """Which optional parts the scene has (part of the cache keys)."""
    return tuple(x is None for x in (
        scene.bvh, scene.tri_clustered, scene.environment,
        scene.environment_presampled, scene.textures))


_ELIGIBLE_CACHE = VersionedCache(32)


def mesh_megakernel_eligible(scene: RenderScene,
                             settings: RenderSettings) -> bool:
    """True when the scene/settings combination is within the kernel's
    scope; everything else renders through the wavefront. The verdict is
    cached per (identity, version) of the scene's tensors and the settings,
    so a frame after a scene's first makes no host sync for it."""
    sources = _scene_sources(scene)
    key, verdict = _ELIGIBLE_CACHE.lookup(sources,
                                          (settings, _scene_shape(scene)))
    if verdict is None:
        verdict = _ELIGIBLE_CACHE.store(
            key, sources, not megakernel_ineligibility_reasons(scene, settings))
    return verdict


# -- packing ------------------------------------------------------------------------

# Host-side caches, each keyed by (identity, version) of the tensors it is
# built from (utils/versioned.py): a ``_replace`` or an in-place write of a
# source tensor is a miss.
_PACK_CACHE = VersionedCache(32)
_STATIC_CACHE = VersionedCache(32)
_ENV_CACHE = VersionedCache(16)
_TEX_CACHE = VersionedCache(16)
_FRAME_CACHE = VersionedCache(32)


def _pack_scene(scene: RenderScene) -> dict:
    """Geometry tables on the scene's device, cached per (identity,
    version) of the geometry tensors:
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
    sources = ((scene.tri_verts, scene.tri_normals_oct, scene.tri_material,
                scene.tri_uvs) + _fields(scene.bvh)
               + _fields(scene.tri_clustered))
    key, packed = _PACK_CACHE.lookup(sources, _scene_shape(scene)[:2])
    if packed is not None:
        return packed
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
        tri = dense_table(tv)
    return _PACK_CACHE.store(key, sources, dict(tri=tri, attr=attr,
                                                n_tris=t, hier=hier))


def dense_table(tri_verts) -> torch.Tensor:
    """[t, 3, 3] triangles → the dense branch's [t_pad, 16] table (v0, e1,
    e2 in columns 0-8, rows padded to a multiple of 8)."""
    tv = tri_verts.to(torch.float32)
    t = int(tv.shape[0])
    tri = torch.zeros((max(8, -(-t // 8) * 8), 16), dtype=torch.float32,
                      device=tv.device)
    tri[:t, 0:9] = torch.cat([tv[:, 0], tv[:, 1] - tv[:, 0],
                              tv[:, 2] - tv[:, 0]], dim=1)
    return tri


def _pack_env(scene: RenderScene):
    """Environment tables for the kernel → (map [h·w, 3], pdf [ph·pw], pool
    [n, 7] (direction 0-2, radiance 3-5, pdf 6) or None, meta) with meta =
    (w, h, pw, ph, n_pool, nee enabled); all None without a map. Plain
    records, cached per (identity, version) of the map, its pdf grid and
    the pool."""
    env = scene.environment
    if env is None:
        return None, None, None, None
    pool = scene.environment_presampled
    sources = (env.image, env.per_pixel_pdf) + _fields(pool)
    key, packed = _ENV_CACHE.lookup(sources, pool is None)
    if packed is not None:
        return packed
    h, w = int(env.image.shape[0]), int(env.image.shape[1])
    ph, pw = env.pdf_size
    img = env.image.to(torch.float32).reshape(h * w, 3).contiguous()
    pdf = env.per_pixel_pdf.to(torch.float32).reshape(-1).contiguous()
    if pool is not None and pool.nee_enabled:
        n_pool = pool.sample_count
        pool_tab = torch.cat([pool.directions, pool.radiances,
                              pool.pdfs[:, None]], dim=1).to(
                                  torch.float32).contiguous()
    else:
        n_pool, pool_tab = 0, None
    meta = (w, h, int(pw), int(ph), n_pool, n_pool > 1)
    return _ENV_CACHE.store(key, sources, (img, pdf, pool_tab, meta))


def _pack_textures(scene: RenderScene):
    """Level 0 of every texture, flattened into one table → (texels [N, 4],
    tex_meta) with tex_meta[i] = (first texel, width, height, wrap_u,
    wrap_v, filter) as Python ints; (None, ()) for a bank of no texture.
    Cached per (identity, version) of the bank's tensors."""
    bank = scene.textures
    if bank is None or bank.count == 0:
        return None, ()
    sources = _fields(bank)
    key, packed = _TEX_CACHE.lookup(sources)
    if packed is not None:
        return packed
    sizes, filters, wraps = (bank.sizes.tolist(), bank.filters.tolist(),
                             bank.wraps.tolist())
    metas, blocks, base = [], [], 0
    for i in range(bank.count):
        h, w = int(sizes[i][0]), int(sizes[i][1])
        blocks.append(bank.data[i, :h, :w, :].reshape(h * w, 4))
        metas.append((base, w, h, int(wraps[i][0]), int(wraps[i][1]),
                      int(filters[i])))
        base += h * w
    texels = torch.cat(blocks, dim=0).to(torch.float32).contiguous()
    return _TEX_CACHE.store(key, sources, (texels, tuple(metas)))


def _live_tables(scene: RenderScene):
    """→ (materials [m, 16], m, lights [n, 12]) from the live scene, laid
    out as in JAX. Material columns: tint 0-2, roughness 3, specularity 4,
    metallic 5, thin-walled 6 (cutouts too), emission 7-9, coverage 10,
    coat 11, coat roughness 12, shading model 13. Light columns: position
    0-2, radius 3, power 4-6, direction 7-9, cos_angle 10. A frame reads
    them through ``_frame_tables``' cache."""
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
    """Kernel-structure statics read on the host and cached per (identity,
    version) of their tensors:
    the light kinds (a runtime switch in the kernel), whether any material
    has a coat (a template parameter) and ``mat_tex``, per material
    (tint-roughness texture, coverage texture, is cutout)."""
    mats = scene.materials
    sources = (scene.lights.kind, mats.flags, mats.tint_roughness_texture,
               mats.coverage_texture, mats.coat)
    key, info = _STATIC_CACHE.lookup(sources)
    if info is not None:
        return info
    info = dict(
        light_kinds=tuple(int(k) for k in scene.lights.kind.tolist()),
        mat_tex=tuple(
            (int(tr), int(cv), int(bool(fl & FLAG_CUTOUT)))
            for tr, cv, fl in zip(mats.tint_roughness_texture.tolist(),
                                  mats.coverage_texture.tolist(),
                                  mats.flags.tolist())),
        has_coat=bool(torch.any(mats.coat > 0.0)))
    return _STATIC_CACHE.store(key, sources, info)


def _rho_tables(device):
    """The two 32×32 GGX rho tables, indexed [roughness][cos_theta]."""
    f = get_fittings(torch.device(device))
    return f.ggx, f.ggx_with_fresnel


def prewarm_megakernel(scene: RenderScene) -> None:
    """Fill the host-side caches for ``scene`` and, on a card, build the
    kernel, so that the first frame pays for neither."""
    _pack_scene(scene)
    _pack_textures(scene)
    _pack_env(scene)
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
    # Per material (tint-roughness texture, coverage texture, is cutout);
    # () = no material binds a texture or is a cutout.
    mat_tex: tuple = ()
    # Per texture (first texel, width, height, wrap_u, wrap_v, filter).
    tex_meta: tuple = ()
    shadow_steps: int = 0   # 0 = one binary any-hit shadow ray
    # (w, h, pw, ph, n_pool, nee enabled); None = tint-only background.
    env_meta: Optional[tuple] = None

    @property
    def any_coverage(self) -> bool:
        """Hits are discarded by coverage (as in the TPU kernel, only when
        shadows march or a material has a coverage texture or is a
        cutout)."""
        return self.shadow_steps > 0 or any(
            mt[1] >= 0 or mt[2] for mt in self.mat_tex)

    @property
    def extras(self) -> bool:
        """The frame needs the environment, texture or coverage code: the
        kernel's ``kExtras`` instantiation."""
        return (self.env_meta is not None or self.any_coverage
                or any(mt[0] >= 0 for mt in self.mat_tex))

    @property
    def n_nee_total(self) -> int:
        """NEE candidates: the lights, and the environment when its pool
        holds more than one sample."""
        return len(self.light_kinds) + int(
            self.env_meta is not None and bool(self.env_meta[5]))


class KernelExtras(NamedTuple):
    """The tables of the environment and texture branches, plain records
    on the scene's device (None where the scene has none)."""

    texels: Optional[torch.Tensor] = None    # [N, 4] level-0 texels
    env_img: Optional[torch.Tensor] = None   # [h·w, 3]
    env_pdf: Optional[torch.Tensor] = None   # [ph·pw]
    env_pool: Optional[torch.Tensor] = None  # [n, 7]


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
    """→ (closest(o, d, live, t_max=inf) → Hit, occluded(o, d, t_max, live)
    → bool [p]) of the plain version: the dense trace over the [t_pad, 16]
    table (with ``stats``, the kernel's chunk-culled one, which counts its
    tests), or with ``cfg.hier`` the lockstep walk over the packed BVH
    ``tri`` (whose ``order`` is the identity, so prim ids are slots). Lanes
    outside ``live`` trace nothing on the BVH branch (t_max = 0 fails the
    root's box); their results are unspecified and masked by the caller."""
    if not cfg.hier and stats is not None:
        # The kernel's culled trace, counting its box and triangle tests.
        def closest(o, d, live, t_max=float("inf")):
            return culled_dense_intersect_reference(
                tri, cfg.n_tris, o, d, eps, t_max, live=live, stats=stats)

        def occluded(o, d, t_max, live):
            return culled_dense_intersect_reference(
                tri, cfg.n_tris, o, d, eps, t_max, any_hit=True, live=live,
                stats=stats).prim >= 0
        return closest, occluded
    if not cfg.hier:
        comp = tri.T                       # the B1 [16, t_pad] layout, a view

        def closest(o, d, live, t_max=float("inf")):
            return dense_intersect_reference(comp, cfg.n_tris, o, d, eps,
                                             t_max)

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

    def closest(o, d, live, t_max=float("inf")):
        return walk(o, d, torch.where(live, t_max, 0.0), False)

    def occluded(o, d, t_max, live):
        return walk(o, d, torch.where(live, t_max, 0.0), True).prim >= 0
    return closest, occluded


def _tex_fetch_nearest(texels, meta, u, v):
    """NEAREST fetch of texture ``meta`` = (first texel, w, h, wrap_u,
    wrap_v, filter) at uv [p] → rgba [p, 4]: ``io/texture.sample_texture``
    texel for texel (v flip, wrap in float space, − 0.5, round half to
    even, integer wrap or clamp), as the TPU kernel's fetch."""
    base, w, h, wrap_u, wrap_v, _ = meta
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


def _interpolated_uv(a, hu, hv):
    """The hit's texcoords from attribute rows 13-18 [24, p]."""
    bary0 = 1.0 - hu - hv
    return (a[13] * bary0 + a[14] * hu + a[15] * hv,
            a[16] * bary0 + a[17] * hu + a[18] * hv)


def _coverage_lanes(cfg: KernelConfig, texels, mat_idx, cov_base, u, v):
    """Per-lane coverage with cutout binarization (the coverage path of
    ``path_tracer._surface_material_params``); ``cov_base`` is the
    material's coverage, or for a cutout its threshold."""
    cov = cov_base
    for k, (_, cov_tex, is_cutout) in enumerate(cfg.mat_tex):
        if cov_tex < 0 and not is_cutout:
            continue
        samp = (_tex_fetch_nearest(texels, cfg.tex_meta[cov_tex], u, v)[:, 0]
                if cov_tex >= 0 else torch.ones_like(cov_base))
        ck = (torch.where(samp < cov_base, 0.0, 1.0) if is_cutout
              else cov_base * samp)
        cov = torch.where(mat_idx == k, ck, cov)
    return cov


def mesh_megakernel_reference(tri, attr, mats, lights, rho_ggx, rho_fres,
                              origin, direction, pixel_hash, active,
                              accumulation: int, scalars, extras,
                              cfg: KernelConfig, stats=None):
    """Plain PyTorch version of the kernel over all lanes at once →
    (r, g, b, rays), each [p]. ``tri`` is the dense [t_pad, 16] table, or
    with ``cfg.hier`` the packed BVH (``_pack_scene``), whose walk is
    :func:`~bifrost3d_tpu_torch.geometry.pallas_bvh.hierarchical_intersect_reference`
    and whose hits index ``attr`` by slot. A ``stats`` dict, if given,
    receives the traces' ``box_tests`` and ``tri_tests`` summed over the
    frame (the BVH walks' nodes and triangles, or the dense trace's chunk
    boxes and the triangles of the chunks it entered), and the shadow rays
    traced: ``shadow_traces`` (one any-hit
    query per shaded hit whose light sample carries radiance) or, with the
    march, ``march_traces``; and ``shaded``, the iterations that shaded a
    hit.

    Mirrors one iteration of the JAX ``_make_kernel`` step in order:
    closest hit, analytic-light hits, miss → background or the environment
    map with MIS, light hit with MIS, attributes by triangle, material row,
    NEAREST tint-roughness texture, coverage (texture, cutout) and the
    stochastic discard, passthrough of culled back faces and discarded
    hits, shading, emission, RIS NEE over the lights and the environment's
    pool with one any-hit shadow ray or the coverage-aware march, BSDF
    sample. ``origin``/``direction`` [p, 3], ``pixel_hash`` int64 holding
    uint32 [p], ``active`` float 0/1 [p], ``scalars`` = (epsilon,
    background rgb, or with a map the environment's tint), ``extras`` the
    :class:`KernelExtras` (None for a frame whose ``cfg.extras`` is false).
    ``rho_ggx``/``rho_fres`` must be the device's own
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
    extras = extras if extras is not None else KernelExtras()
    texels = extras.texels
    env_light = env_sampler = None
    if cfg.env_meta is not None:
        w, h, pw, ph, n_pool, env_nee = cfg.env_meta
        env_light = EnvironmentLight(
            image=extras.env_img.reshape(h, w, 3), tint=env_tint,
            distribution=None, per_pixel_pdf=extras.env_pdf.reshape(ph, pw))
        if env_nee:
            pool = PresampledEnvironmentLight(
                light=env_light, directions=extras.env_pool[:, 0:3],
                radiances=extras.env_pool[:, 3:6], pdfs=extras.env_pool[:, 6])

            def env_sampler(u3):
                return presampled_environment_sample(pool, u3[..., 0])
    tint_textured = any(mt[0] >= 0 for mt in cfg.mat_tex)
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

        if env_light is not None:
            e_pdf = environment_pdf(env_light, d)
            w_env = torch.where(bsdf_pdf > 0.0, mis_weight(bsdf_pdf, e_pdf),
                                1.0)
            env_rad = environment_evaluate(env_light, d) * w_env[:, None]
        else:
            env_rad = env_tint
        radiance = radiance + torch.where(miss[:, None],
                                          throughput * env_rad, 0.0)
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
        m_tint, m_rough = m[:, 0:3], m[:, 3]
        if tint_textured or cfg.any_coverage:
            u_uv, v_uv = _interpolated_uv(a, hu, hv)
        if tint_textured:
            tex = torch.ones((p, 4), dtype=torch.float32, device=device)
            for k, (tr_tex, _, _) in enumerate(cfg.mat_tex):
                if tr_tex >= 0:
                    tex = torch.where(
                        (a[9] == k)[:, None],
                        _tex_fetch_nearest(texels, cfg.tex_meta[tr_tex],
                                           u_uv, v_uv), tex)
            m_tint, m_rough = m_tint * tex[:, 0:3], m_rough * tex[:, 3]

        u_bsdf = path_rng_4d(accumulation, pixel_hash,
                             bounce * Dimension.PER_BOUNCE + Dimension.BSDF)
        u_nee = path_rng_4d(accumulation, pixel_hash,
                            bounce * Dimension.PER_BOUNCE + Dimension.NEE)

        hit_from_front = dot(geo_n, d) < 0.0
        skip = ~hit_from_front & ~thin_walled       # a culled back face
        if cfg.any_coverage:
            # Stochastic transparency: a hit whose coverage is below the
            # bounce's fourth BSDF number lets the ray pass.
            cov = _coverage_lanes(cfg, texels, a[9], m[:, 10], u_uv, v_uv)
            skip = skip | (cov < u_bsdf[:, 3])
        passthrough = mesh_hit & skip
        shade = mesh_hit & ~skip
        front = hit_from_front[:, None]
        gf = torch.where(front, geo_n, -geo_n)
        sn = _fix_backfacing_shading_normal(
            -d, torch.where(front, shading_n, -shading_n))
        wo = to_local(-d, sn)
        cos_theta_o = torch.where(hit_from_front | thin_walled, wo[:, 2],
                                  -wo[:, 2])
        bundle = _create_shading(present, model, m_tint, m_rough, m[:, 4],
                                 m[:, 5], coat, coat_r, cos_theta_o)
        radiance = radiance + torch.where(shade[:, None],
                                          throughput * m[:, 7:10], 0.0)
        if stats is not None:
            stats["shaded"] = stats.get("shaded", 0) + int(shade.sum())

        nee_valid = torch.zeros(p, dtype=torch.bool, device=device)
        if cfg.n_nee_total > 0 and cfg.ris_count > 0:
            l_dir, l_dist, l_rad, nee_valid = _reestimated_light_samples(
                light_arr, bundle, position, wo, sn, u_nee, cfg.ris_count,
                cfg.delta_light_clamp, env_sampler)
            l_rad = l_rad * throughput
            side = torch.where(dot(l_dir, gf) >= 0.0, 1.0, -1.0)
            shadow_origin = offset_ray_origin(position, gf * side[:, None])
            has_light = shade & (torch.amax(l_rad, dim=-1) > 0.0)
            t_shadow = l_dist * (1.0 - 1e-4)
            if cfg.shadow_steps > 0:
                trans = _shadow_march(cfg, closest, attr, mats, texels,
                                      shadow_origin, l_dir, t_shadow, eps,
                                      has_light, stats)
            else:
                if stats is not None:
                    stats["shadow_traces"] = stats.get(
                        "shadow_traces", 0) + int(has_light.sum())
                trans = torch.where(occluded_by(shadow_origin, l_dir,
                                                t_shadow, has_light), 0.0, 1.0)
            radiance = radiance + torch.where(has_light[:, None],
                                              l_rad * trans[:, None], 0.0)

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


def _shadow_march(cfg: KernelConfig, closest, attr, mats, texels, origin,
                  direction, t_max, eps, live, stats=None):
    """The coverage-aware shadow march of the kernel → transmittance [p]
    (``path_tracer._shadow_transmittance`` over the kernel's tables): up to
    ``cfg.shadow_steps`` closest hits, each but the last multiplying by
    1 − coverage and moving the origin past the surface by t + eps; what
    the last one still hits occludes fully. A lane whose step hit nothing,
    or whose transmittance is 0, has its answer (a later step searches a
    part of the same segment) and marches no further, as a thread of the
    kernel; ``stats["march_traces"]`` counts the traces made."""
    trans = torch.ones_like(t_max)
    t_rem = t_max
    for step in range(cfg.shadow_steps):
        if stats is not None:
            stats["march_traces"] = stats.get("march_traces", 0) + int(
                live.sum())
        hit = closest(origin, direction, live, t_rem)
        hit_mask = live & (hit.prim >= 0)
        blocked = hit_mask & (trans > 0.0)
        if step == cfg.shadow_steps - 1:
            return torch.where(blocked, 0.0, trans)
        a = attr[:, torch.clamp_min(hit.prim, 0).long()]
        u_uv, v_uv = _interpolated_uv(a, hit.u, hit.v)
        cov = _coverage_lanes(cfg, texels, a[9], mats[a[9].long(), 10],
                              u_uv, v_uv)
        trans = torch.where(blocked, trans * (1.0 - cov), trans)
        live = blocked & (trans > 0.0)
        advance = torch.where(hit_mask, hit.t, 0.0) + eps
        origin = origin + direction * advance[:, None]
        t_rem = t_rem - advance
    return trans


# -- the CUDA kernel ---------------------------------------------------------------

class _Params(ctypes.Structure):
    """Mirror of ``MegakernelParams`` in csrc/mesh_megakernel.cu."""

    _fields_ = [
        ("tri", ctypes.c_void_p), ("records", ctypes.c_void_p),
        ("attr", ctypes.c_void_p),
        ("mats", ctypes.c_void_p), ("lights", ctypes.c_void_p),
        ("rho_ggx", ctypes.c_void_p), ("rho_fres", ctypes.c_void_p),
        ("sobol", ctypes.c_void_p),
        ("cam_inv_proj", ctypes.c_void_p),
        ("cam_translation", ctypes.c_void_p),
        ("cam_rotation", ctypes.c_void_p), ("cam_scale", ctypes.c_void_p),
        ("scalars", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("texels", ctypes.c_void_p), ("tex_meta", ctypes.c_void_p),
        ("mat_tex", ctypes.c_void_p), ("env_img", ctypes.c_void_p),
        ("env_pdf", ctypes.c_void_p), ("env_pool", ctypes.c_void_p),
        ("width", ctypes.c_int), ("height", ctypes.c_int),
        ("tile_w", ctypes.c_int), ("tile_h", ctypes.c_int),
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
        ("extras", ctypes.c_int), ("n_tex", ctypes.c_int),
        ("any_coverage", ctypes.c_int), ("shadow_steps", ctypes.c_int),
        ("has_env", ctypes.c_int), ("env_w", ctypes.c_int),
        ("env_h", ctypes.c_int), ("env_pw", ctypes.c_int),
        ("env_ph", ctypes.c_int), ("env_pool_n", ctypes.c_int),
        ("n_nee_total", ctypes.c_int),
        ("accum", ctypes.c_void_p), ("inv_n", ctypes.c_float),
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
    lib.megakernel_camera_probe.argtypes = [
        ctypes.POINTER(_Params), ctypes.c_void_p, ctypes.c_void_p]
    lib.megakernel_camera_probe.restype = ctypes.c_int
    lib.megakernel_trace_probe.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.megakernel_trace_probe.restype = ctypes.c_int
    lib.megakernel_hier_trace_probe.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.megakernel_hier_trace_probe.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sobol_dirs(device: torch.device) -> torch.Tensor:
    """The port's [4, 32] Sobol direction numbers as int32 bits on device."""
    dirs = sobol_direction_numbers().view(np.int32)
    return torch.tensor(dirs, device=device).contiguous()


def _as_int32_bits(x):
    """int64 tensor of uint32 values → int32 with the same 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


_RIS_OFFSETS = tuple(float(v) for v in
                     _reverse_halton_offsets(MAX_RIS).reshape(-1))


class CameraFrame(NamedTuple):
    """What the kernel makes its camera lanes from: the camera (its
    inverse projection and transform, read on the device), the frame's
    size and the pixel tile a warp covers (None = raster order; a tile
    that does not divide the frame means raster order too, as
    :func:`pixel_order`)."""

    camera: PinholeCamera
    width: int
    height: int
    tile: Optional[tuple] = None

    def tile_dims(self) -> tuple:
        """(tile_w, tile_h) for the kernel; (0, 0) for raster order."""
        t = self.tile
        if t is None or self.width % t[0] or self.height % t[1]:
            return 0, 0
        return int(t[0]), int(t[1])


@functools.lru_cache(maxsize=64)
def _int_table(rows: tuple, width: int, device: torch.device) -> torch.Tensor:
    """A tuple of int tuples as an int32 [n, width] tensor on ``device``
    (rows padded with zeros), kept per value."""
    table = np.zeros((max(len(rows), 1), width), np.int32)
    for k, row in enumerate(rows):
        table[k, :len(row)] = row
    return torch.tensor(table, device=device)


def _check_extras(extras: KernelExtras, cfg: KernelConfig, n_mats: int,
                  device) -> None:
    """Hold the extras' tables against what ``cfg`` says of them."""
    if len(cfg.mat_tex) != n_mats:
        raise ValueError("mat_tex must hold one entry per material")
    bound = {b for mt in cfg.mat_tex for b in mt[:2] if b >= 0}
    if bound:
        if extras.texels is None or max(bound) >= len(cfg.tex_meta):
            raise ValueError("a material binds a texture the tables lack")
        n_texels = sum(meta[1] * meta[2] for meta in cfg.tex_meta)
        if n_texels > MAX_TEX_TEXELS or \
                extras.texels.shape != (n_texels, 4):
            raise ValueError(f"texels must be [<= {MAX_TEX_TEXELS}, 4], "
                             "level 0 of every texture in turn")
        if any(cfg.tex_meta[b][5] != FILTER_NONE for b in bound):
            raise ValueError("the kernel fetches NEAREST textures only")
        _check("texels", extras.texels, torch.float32, device)
    if cfg.env_meta is not None:
        w, h, pw, ph, n_pool, env_nee = cfg.env_meta
        if w * h > MAX_ENV_TEXELS or pw * ph > MAX_ENV_PDF \
                or n_pool > MAX_ENV_POOL:
            raise ValueError("the environment's map, pdf grid or pool is "
                             "over the kernel's budget")
        if extras.env_img is None or extras.env_img.shape != (h * w, 3) \
                or extras.env_pdf is None \
                or extras.env_pdf.shape != (ph * pw,):
            raise ValueError("env_img must be [h·w, 3] and env_pdf [ph·pw]")
        _check("env_img", extras.env_img, torch.float32, device)
        _check("env_pdf", extras.env_pdf, torch.float32, device)
        if bool(env_nee) != (n_pool > 1):
            raise ValueError("environment NEE needs a pool of more than "
                             "one sample, and such a pool enables it")
        if env_nee:
            if extras.env_pool is None or \
                    extras.env_pool.shape != (n_pool, 7):
                raise ValueError("env_pool must be [n_pool, 7]")
            _check("env_pool", extras.env_pool, torch.float32, device)


def _camera_params(frame: CameraFrame, device) -> dict:
    """The camera's pointers and the frame's size for ``_Params``, checked."""
    cam = frame.camera
    width, height = int(frame.width), int(frame.height)
    if width <= 0 or height <= 0 or width * height >= 2**31 // 4:
        raise ValueError(f"frame {width}x{height} outside the kernel's range")
    t = cam.transform
    for name, x, numel in (("inverse_projection", cam.inverse_projection, 16),
                           ("translation", t.translation, 3),
                           ("rotation", t.rotation, 4), ("scale", t.scale, 1)):
        _check(f"camera {name}", x, torch.float32, device)
        if x.numel() != numel:
            raise ValueError(f"camera {name} must hold {numel} floats")
    tile_w, tile_h = frame.tile_dims()
    return dict(cam_inv_proj=cam.inverse_projection.data_ptr(),
                cam_translation=t.translation.data_ptr(),
                cam_rotation=t.rotation.data_ptr(),
                cam_scale=t.scale.data_ptr(), width=width, height=height,
                tile_w=tile_w, tile_h=tile_h, n_pixels=width * height)


def _walk_records(tree: HierTriangles, device) -> torch.Tensor:
    """The tree's child records, checked for the BVH branch's walk."""
    records = tree.child_records
    if records.dim() != 2 or records.shape[1] != 16 or records.shape[0] < 1:
        raise ValueError("child_records must be [n >= 1, 16]")
    if tree.max_depth + 1 > STACK_SIZE:
        raise ValueError(f"BVH depth {tree.max_depth} exceeds the kernel "
                         f"stack ({STACK_SIZE})")
    _check("child_records", records, torch.float32, device)
    return records


def _launch_params(tri, attr, mats, lights, rho_ggx, rho_fres,
                   frame: CameraFrame, accumulation: int, scalars, extras,
                   cfg: KernelConfig) -> tuple:
    """The checked ``_Params`` of one frame, with ``out`` and ``accum`` left
    null → (params, the tables made here that params points at)."""
    device = scalars.device
    n_lights = len(cfg.light_kinds)
    if cfg.hier != isinstance(tri, HierTriangles):
        raise TypeError("tri must be the packed BVH with cfg.hier, the "
                        "dense [t_pad, 16] table without")
    records = None
    if cfg.hier:
        tree, tri = tri, tri.tri_components
        if not 0 < cfg.n_tris <= HIER_MAX_TRIS \
                or cfg.n_tris != tree.n_tris \
                or tri.shape != (cfg.n_tris, 12):
            raise ValueError(f"n_tris={cfg.n_tris} outside (0, "
                             f"{HIER_MAX_TRIS}] or not the packed tree's")
        records = _walk_records(tree, device)
    else:
        if not 0 < cfg.n_tris <= min(MAX_TRIS, tri.shape[0]):
            raise ValueError(f"n_tris={cfg.n_tris} outside (0, "
                             f"{MAX_TRIS}] or the packed table")
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
        raise ValueError(f"ris_count {cfg.ris_count} outside "
                         f"[0, {MAX_RIS}]")
    if rho_ggx.shape != (32, 32) or rho_fres.shape != (32, 32):
        raise ValueError("the rho tables must be [32, 32]")
    for name, x in (("tri", tri), ("attr", attr), ("mats", mats),
                    ("lights", lights), ("rho_ggx", rho_ggx),
                    ("rho_fres", rho_fres), ("scalars", scalars)):
        _check(name, x, torch.float32, device)
    if scalars.shape != (4,):
        raise ValueError("scalars must be [4]: epsilon, background rgb")
    if not 0 <= cfg.shadow_steps <= 16:
        raise ValueError(f"shadow_steps {cfg.shadow_steps} outside "
                         "[0, 16]")
    camera = _camera_params(frame, device)
    extras = extras if extras is not None else KernelExtras()
    tex_meta = mat_tex = None
    if cfg.extras:
        _check_extras(extras, cfg, int(mats.shape[0]), device)
        tex_meta = _int_table(cfg.tex_meta, 6, device)
        mat_tex = _int_table(cfg.mat_tex, 4, device)
    env = cfg.env_meta or (0, 0, 0, 0, 0, False)

    def ptr(x):
        return 0 if x is None else x.data_ptr()

    params = _Params(
        tri=tri.data_ptr(), records=ptr(records), attr=attr.data_ptr(),
        mats=mats.data_ptr(), lights=lights.data_ptr(),
        rho_ggx=rho_ggx.data_ptr(), rho_fres=rho_fres.data_ptr(),
        sobol=_sobol_dirs(device).data_ptr(), scalars=scalars.data_ptr(),
        texels=ptr(extras.texels), tex_meta=ptr(tex_meta),
        mat_tex=ptr(mat_tex), env_img=ptr(extras.env_img),
        env_pdf=ptr(extras.env_pdf), env_pool=ptr(extras.env_pool),
        extras=int(cfg.extras), n_tex=len(cfg.tex_meta),
        any_coverage=int(cfg.any_coverage), shadow_steps=cfg.shadow_steps,
        has_env=int(cfg.env_meta is not None), env_w=env[0], env_h=env[1],
        env_pw=env[2], env_ph=env[3], env_pool_n=env[4],
        n_nee_total=cfg.n_nee_total, n_tris=cfg.n_tris,
        t_pad=int(tri.shape[0]), n_mats=int(mats.shape[0]),
        n_lights=n_lights,
        accumulation=int(accumulation) & 0xFFFFFFFF, n_iters=cfg.n_iters,
        max_bounce=cfg.max_bounce, ris_count=cfg.ris_count,
        firefly_clamp=cfg.firefly_clamp,
        delta_light_clamp=cfg.delta_light_clamp,
        has_coat=int(cfg.has_coat), has_diffuse=int(cfg.has_diffuse),
        hier=int(cfg.hier), **camera)
    for k, kind in enumerate(cfg.light_kinds):
        params.light_kinds[k] = kind
    params.ris_offsets[:] = _RIS_OFFSETS
    return params, (tex_meta, mat_tex)


def _launch(params: _Params, stream) -> None:
    """One launch of the kernel on ``stream``; a failed launch raises."""
    global launch_count
    err = _library().mesh_megakernel(ctypes.byref(params), _THREADS, stream)
    if err != 0:
        raise RuntimeError(f"mesh_megakernel launch failed: cudaError {err}")
    launch_count += 1


def mesh_megakernel_cuda(tri, attr, mats, lights, rho_ggx, rho_fres,
                         frame: CameraFrame, accumulation: int, scalars,
                         extras, cfg: KernelConfig):
    """Launch ``csrc/mesh_megakernel.cu`` on the current stream → (radiance
    [height, width, 3], rays [height·width]) in raster order, both views of
    one allocation. The kernel makes its own camera lanes from ``frame``
    (:func:`megakernel_frame_inputs`); the other arguments are those of
    :func:`mesh_megakernel_reference` (``tri`` the dense table, or with
    ``cfg.hier`` the packed BVH). A frame whose ``cfg.extras`` is true
    launches the ``kExtras`` instantiation. Under a ``torch.profiler``
    session the call, from its checks to the launch's return, is span
    ``b3d.megakernel.launch``."""
    with span("megakernel.launch"):
        params, _ = _launch_params(tri, attr, mats, lights, rho_ggx, rho_fres,
                                   frame, accumulation, scalars, extras, cfg)
        p = params.n_pixels
        out = torch.empty(4 * p, dtype=torch.float32, device=scalars.device)
        params.out = out.data_ptr()
        _launch(params, torch.cuda.current_stream(scalars.device).cuda_stream)
        return out[:3 * p].view(frame.height, frame.width, 3), out[3 * p:]


def camera_probe(frame: CameraFrame, accumulation: int):
    """The camera lanes the kernel's prologue makes for ``frame`` → (pixel
    hash int64 [n] of uint32 values, origin [n, 3], direction [n, 3],
    active bool [n]), in raster order, for holding against
    ``path_tracer._camera_lanes``. Every pixel not written stays NaN."""
    device = frame.camera.inverse_projection.device
    camera = _camera_params(frame, device)
    out = torch.full((camera["n_pixels"], 8), float("nan"),
                     dtype=torch.float32, device=device)
    params = _Params(sobol=_sobol_dirs(device).data_ptr(),
                     accumulation=int(accumulation) & 0xFFFFFFFF, **camera)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _library().megakernel_camera_probe(ctypes.byref(params),
                                             out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"megakernel_camera_probe launch failed: "
                           f"cudaError {err}")
    hashes = out[:, 7].contiguous().view(torch.int32).to(torch.int64) \
        & 0xFFFFFFFF
    return hashes, out[:, 0:3], out[:, 3:6], out[:, 6] > 0.5


def trace_probe(tri, n_tris: int, origin, direction, t_min: float,
                t_max: float, any_hit: bool = False) -> Hit:
    """The dense branch's staged, chunk-culled trace on its own, for rays
    [r, 3] over the [t_pad, 16] table (``_pack_scene``'s layout, at most
    ``MAX_TRIS`` triangles) → Hit (t = inf, prim = -1 on a miss; with
    ``any_hit`` the first hit in index order)."""
    device = origin.device
    r = int(origin.shape[0])
    if origin.shape != (r, 3) or direction.shape != (r, 3):
        raise ValueError("origin and direction must both be [r, 3]")
    if not 0 < n_tris <= min(MAX_TRIS, tri.shape[0]) or tri.shape[1] != 16:
        raise ValueError(f"tri must be [t_pad, 16] with 0 < n_tris <= "
                         f"{MAX_TRIS}")
    for name, x in (("tri", tri), ("origin", origin),
                    ("direction", direction)):
        _check(name, x, torch.float32, device)
    out = torch.empty((4, r), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _library().megakernel_trace_probe(
        tri.data_ptr(), int(n_tris), origin.data_ptr(), direction.data_ptr(),
        r, float(t_min), float(t_max), int(any_hit), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"megakernel_trace_probe launch failed: "
                           f"cudaError {err}")
    return _finish(out[0], out[1].view(torch.int32), out[2], out[3])


def hier_trace_probe(tree: HierTriangles, origin, direction, t_min: float,
                     t_max, any_hit: bool = False) -> Hit:
    """The BVH branch's walk on its own, as csrc/mesh_megakernel.cu builds
    it, for rays [r, 3] from ``t_min`` to ``t_max`` (a number or [r]) → Hit
    as ``pallas_bvh.hierarchical_intersect_cuda`` returns it (prim =
    ``tree.order[slot]``), for holding it bit for bit against that
    kernel, which builds the same walk in its own library."""
    device = origin.device
    r = int(origin.shape[0])
    if origin.shape != (r, 3) or direction.shape != (r, 3):
        raise ValueError("origin and direction must both be [r, 3]")
    records = _walk_records(tree, device)
    t_max = ray_bounds(t_max, r, origin).contiguous()
    for name, x in (("tri_components", tree.tri_components),
                    ("origin", origin), ("direction", direction),
                    ("t_max", t_max)):
        _check(name, x, torch.float32, device)
    _check("order", tree.order, torch.int32, device)
    out = torch.empty((4, r), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _library().megakernel_hier_trace_probe(
        records.data_ptr(), tree.tri_components.data_ptr(),
        tree.order.data_ptr(), origin.data_ptr(), direction.data_ptr(), r,
        float(t_min), t_max.data_ptr(), int(any_hit), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"megakernel_hier_trace_probe launch failed: "
                           f"cudaError {err}")
    return Hit(t=out[0], prim=out[1].view(torch.int32), u=out[2], v=out[3])


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
    tile does not divide, gives raster order. The kernel computes the same
    map per thread (``lane_pixel``)."""
    flat = torch.arange(width * height, dtype=torch.int64, device=device)
    if tile is None or width % tile[0] or height % tile[1]:
        return flat
    tw, th = tile
    return flat.reshape(height // th, th, width // tw, tw).permute(
        0, 2, 1, 3).reshape(-1)


def _frame_tables(scene: RenderScene, settings: RenderSettings) -> tuple:
    """(tri, attr, mats, lights, rho_ggx, rho_fres, scalars, extras, cfg)
    of a frame: the pack caches' tables, the live material and light
    tables, and epsilon with the background tint (with a map, the
    environment's own tint, which its evaluation multiplies in). Cached
    per (identity, version) of every scene tensor and the settings, so a
    frame after a scene's first reads nothing on the host."""
    sources = _scene_sources(scene)
    key, tables = _FRAME_CACHE.lookup(sources,
                                      (settings, _scene_shape(scene)))
    if tables is not None:
        return tables
    packed = _pack_scene(scene)
    mats, _, lights = _live_tables(scene)
    info = _static_info(scene)
    device = scene.tri_verts.device
    rho_ggx, rho_fres = _rho_tables(device)
    texels, tex_meta = _pack_textures(scene)
    env_img, env_pdf, env_pool, env_meta = _pack_env(scene)
    cfg = KernelConfig(
        n_tris=packed["n_tris"], light_kinds=info["light_kinds"],
        n_iters=settings.max_bounce_count + 1 + settings.passthrough_slack,
        max_bounce=settings.max_bounce_count,
        ris_count=settings.next_event_sample_count,
        firefly_clamp=float(settings.firefly_clamp),
        delta_light_clamp=float(settings.delta_light_clamp),
        has_coat=info["has_coat"],
        has_diffuse=SHADING_DIFFUSE in scene.shading_models,
        hier=packed["hier"], mat_tex=info["mat_tex"], tex_meta=tex_meta,
        shadow_steps=(settings.shadow_coverage_steps
                      if settings.coverage_aware_shadows else 0),
        env_meta=env_meta)
    extras = (KernelExtras(texels, env_img, env_pdf, env_pool)
              if cfg.extras else None)
    tint = (scene.environment.tint if scene.environment is not None
            else scene.environment_tint)
    scalars = torch.cat([scene.scene_epsilon.reshape(1).to(torch.float32),
                         tint.to(torch.float32)])
    return _FRAME_CACHE.store(key, sources, (
        packed["tri"], packed["attr"], mats, lights, rho_ggx, rho_fres,
        scalars, extras, cfg))


def megakernel_inputs(scene: RenderScene, camera, width: int, height: int,
                      accumulation: int,
                      settings: RenderSettings = RenderSettings(),
                      pixel_tile=None) -> tuple:
    """The plain version's arguments for one frame (those of
    :func:`mesh_megakernel_reference`): the frame's tables and its camera
    lanes, made in torch (``path_tracer._camera_lanes``), one lane per
    pixel in the order of :func:`pixel_order` (raster order without a
    ``pixel_tile``: the JAX dense branch's identity layout). A pixel's
    result does not depend on its lane. The kernel makes the same lanes
    itself (:func:`megakernel_frame_inputs`)."""
    tri, attr, mats, lights, rho_ggx, rho_fres, scalars, extras, cfg = \
        _frame_tables(scene, settings)
    accumulation = int(accumulation)
    flat = pixel_order(width, height, pixel_tile, scene.tri_verts.device)
    lanes = _camera_lanes(camera, flat % width, flat // width, width, height,
                          accumulation, torch.ones_like(flat, dtype=torch.bool))
    return (tri, attr, mats, lights, rho_ggx, rho_fres,
            lanes.origin.contiguous(), lanes.direction.contiguous(),
            lanes.pixel_hash, lanes.active.to(torch.float32), accumulation,
            scalars, extras, cfg)


def megakernel_frame_inputs(scene: RenderScene, camera, width: int,
                            height: int, accumulation: int,
                            settings: RenderSettings = RenderSettings()
                            ) -> tuple:
    """The kernel's arguments for one frame (those of
    :func:`mesh_megakernel_cuda`): the frame's tables and a
    :class:`CameraFrame`, whose tile is ``HIER_PIXEL_TILE`` on the BVH
    branch and raster order on the dense one."""
    tri, attr, mats, lights, rho_ggx, rho_fres, scalars, extras, cfg = \
        _frame_tables(scene, settings)
    frame = CameraFrame(camera, int(width), int(height),
                        HIER_PIXEL_TILE if cfg.hier else None)
    return (tri, attr, mats, lights, rho_ggx, rho_fres, frame,
            int(accumulation), scalars, extras, cfg)


def render_mesh_megakernel(scene: RenderScene, camera, width: int,
                           height: int, accumulation: int,
                           settings: RenderSettings = RenderSettings(),
                           sum_rays: bool = True):
    """One progressive frame through the mesh megakernel → (radiance
    [height, width, 3], rays [] — live lanes × 2 per iteration, the same
    in-run tally the pooled wavefront reports; on the card it stays there
    until read). On the card this is one launch of the kernel (and one for
    the ray sum); on the CPU the plain version renders raster lanes.
    ``sum_rays`` False returns each lane's tally [height·width] instead,
    and launches no sum."""
    device = scene.tri_verts.device
    if device.type == "cuda":
        img, rays = mesh_megakernel_cuda(*megakernel_frame_inputs(
            scene, camera, width, height, accumulation, settings))
    elif device.type == "cpu":
        r, g, b, rays = mesh_megakernel_reference(*megakernel_inputs(
            scene, camera, width, height, accumulation, settings))
        img = torch.stack([r, g, b], dim=-1).reshape(height, width, 3)
    else:
        raise ValueError(f"no mesh megakernel for a scene on {device}")
    return img, (rays.sum() if sum_rays else rays)


class MegakernelAccumulator:
    """The progressive loop's prepared launch on the card: accumulation
    after accumulation of ``scene`` seen from ``camera``, each lerped by the
    kernel into the running mean ``buffer`` [height, width, 3] in place, bit
    for bit torch's eager ``buffer + (frame - buffer) / (n + 1)`` over
    :func:`render_mesh_megakernel`'s frames. The frame's tables, every
    check and the launch's arguments are made once, here; an accumulation
    sets its number and weight and makes the call (the kernel takes its
    arguments by value, so they may change as soon as the call returns).
    The scene, the camera and the buffer must stay as they are while it is
    used."""

    def __init__(self, scene: RenderScene, camera, width: int, height: int,
                 settings: RenderSettings, buffer):
        inputs = megakernel_frame_inputs(scene, camera, width, height, 0,
                                         settings)
        device = scene.tri_verts.device
        if buffer.shape != (height, width, 3) \
                or buffer.dtype != torch.float32 or buffer.device != device \
                or not buffer.is_contiguous():
            raise ValueError(f"buffer must be a contiguous float32 [{height}, "
                             f"{width}, 3] on {device}")
        self._params, made = _launch_params(*inputs)
        self._params.accum = buffer.data_ptr()
        self._keep = (inputs, made, buffer)
        self._stream = torch.cuda.current_stream(device).cuda_stream

    def accumulate(self, n: int) -> None:
        """Accumulation ``n`` (from 0) lerped into the buffer with weight
        1 / (n + 1): one launch, span ``b3d.megakernel.launch``."""
        global accumulate_count
        with span("megakernel.launch"):
            self._params.accumulation = int(n) & 0xFFFFFFFF
            # torch divides by a host scalar on the card as a multiplication
            # by the scalar's float32 reciprocal.
            self._params.inv_n = float(np.float32(1) / np.float32(n + 1))
            _launch(self._params, self._stream)
            accumulate_count += 1
