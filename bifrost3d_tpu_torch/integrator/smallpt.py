"""SmallPT: wavefront sphere path tracer (diffuse / mirror / glass).

Port of ``bifrost3d_tpu/integrator/smallpt.py``: constants,
``_tent_jitter``, ``_diffuse_dir``, ``_bounce``, ``smallpt_camera_ray``,
``_initial_lane_state``, ``render_smallpt_pixels``,
``render_smallpt_pooled(_counted)``, ``render_smallpt_accumulation`` and
``render_smallpt``. Every lane advances one bounce per step under masks;
JAX's ``fori_loop``/``while_loop`` become Python loops. This eager
wavefront is the estimator every other SmallPT piece is held to, the CUDA
megakernel (``integrator/pallas_smallpt.py``) included.

The sample chain is the JAX package's: the LCG of ``sampling.hashes``
seeded per pixel with ``jenkins_hash(2x2-stratified index) ^
reverse_bits(accumulation)``, two draws for the tent-filter jitter, one
for Russian roulette once ``depth + 1 > 5`` on a live hit, two for a
diffuse bounce, one for glass outside total internal reflection, none for
the mirror. Glass always takes the Fresnel roulette (P = 0.25 + 0.5·Re).
"""

from __future__ import annotations

import math

import torch

from bifrost3d_tpu_torch.math.vec import cross, dot, normalize, reflect
from bifrost3d_tpu_torch.sampling.hashes import (
    jenkins_hash,
    lcg_next,
    reverse_bits,
    u32,
)
from bifrost3d_tpu_torch.scene.spheres import (
    BSDF_DIFFUSE,
    BSDF_GLASS,
    SphereScene,
    intersect_spheres,
)

SMALLPT_CAM_ORIGIN = (50.0, 52.0, 295.6)
SMALLPT_CAM_DIRECTION = (0.0, -0.042612, -1.0)
MAX_DEPTH = 20
RR_START_DEPTH = 5
GLASS_RR_START_DEPTH = 0  # reference: 2 (splits before that; see docstring)
EPS = 1e-2  # t-min epsilon, scaled up from the reference's 1e-4 for float32
# Ray-origin offset along the geometric normal: hit positions on the
# 1e5-radius wall spheres carry ~0.02 absolute error in float32, so new rays
# start half a tenth of a scene unit off the surface to avoid re-hits.
ORIGIN_OFFSET = 0.05
_TWO_PI = 2.0 * math.pi


def _tent_jitter(u):
    """Tent-filter reconstruction jitter in [-1, 1] (smallpt.h:133-135)."""
    r = 2.0 * u
    return torch.where(r < 1.0, torch.sqrt(r) - 1.0,
                       1.0 - torch.sqrt(torch.clamp_min(2.0 - r, 0.0)))


def _diffuse_dir(nl, u1, u2):
    """Cosine-hemisphere direction about nl, smallpt's tangent frame."""
    r1 = _TWO_PI * u1
    r2s = torch.sqrt(u2)
    w = nl
    up = torch.where(torch.abs(w[..., 0:1]) > 0.1,
                     w.new_tensor([0.0, 1.0, 0.0]),
                     w.new_tensor([1.0, 0.0, 0.0]))
    u = normalize(cross(up, w))
    v = cross(w, u)
    return normalize(u * (torch.cos(r1) * r2s)[..., None]
                     + v * (torch.sin(r1) * r2s)[..., None]
                     + w * torch.sqrt(torch.clamp_min(1.0 - u2, 0.0))[..., None])


def _bounce(scene: SphereScene, state, depth):
    """One wavefront bounce. state = (origin, direction, throughput,
    radiance, rng, active); ``depth`` is an int (the dense loop's counter)
    or a per-lane tensor (the pooled wavefront)."""
    origin, direction, throughput, radiance, rng, active = state

    t, idx, hit = intersect_spheres(scene, origin, direction, eps=EPS)
    idx = torch.clamp_min(idx, 0).long()
    emission = scene.emission[idx]
    color = scene.color[idx]
    bsdf = scene.bsdf[idx]

    live = active & hit
    radiance = radiance + torch.where(live[..., None], throughput * emission,
                                      0.0)

    # Miss lanes carry t = inf: pin them to their origins.
    t_safe = torch.where(hit, t, 0.0)
    pos = origin + direction * t_safe[..., None]
    norm = normalize(pos - scene.position[idx])
    n_dot_d = dot(norm, direction)
    nl = torch.where(n_dot_d[..., None] < 0.0, norm, -norm)

    f = color
    max_refl = torch.amax(f, dim=-1)

    # Russian roulette once (depth + 1) > 5 (smallpt.h:79-81); it draws
    # only on lanes that are live hits.
    rr_on = torch.as_tensor(depth, device=origin.device) + 1 > RR_START_DEPTH
    rng_rr, u_rr = lcg_next(rng)
    rng = torch.where(rr_on & live, rng_rr, rng)
    survive = torch.where(rr_on, u_rr < max_refl, True)
    f = torch.where(rr_on[..., None],
                    f / torch.clamp_min(max_refl, 1e-6)[..., None], f)
    live = live & survive

    # Diffuse: cosine hemisphere sample (2 draws).
    is_diffuse = live & (bsdf == BSDF_DIFFUSE)
    rng_d1, u1 = lcg_next(rng)
    rng_d2, u2 = lcg_next(rng_d1)
    dir_diffuse = _diffuse_dir(nl, u1, u2)

    dir_mirror = reflect(direction, nl)

    # Glass: Fresnel Russian roulette between reflection and refraction.
    is_glass = live & (bsdf == BSDF_GLASS)
    refl_dir = reflect(direction, norm)
    into = dot(norm, nl) > 0.0
    nc, nt = 1.0, 1.5
    nnt = torch.where(into, nc / nt, nt / nc)
    ddn = dot(direction, nl)
    cos2t = 1.0 - nnt * nnt * (1.0 - ddn * ddn)
    tir = cos2t < 0.0
    sqrt_cos2t = torch.sqrt(torch.clamp_min(cos2t, 0.0))
    tdir = normalize(
        direction * nnt[..., None]
        - norm * (torch.where(into, 1.0, -1.0)
                  * (ddn * nnt + sqrt_cos2t))[..., None])
    r0 = ((nt - nc) / (nt + nc)) ** 2
    c = 1.0 - torch.where(into, -ddn, dot(tdir, norm))
    c2 = c * c
    re = r0 + (1.0 - r0) * (c2 * c2 * c)
    tr = 1.0 - re
    p = 0.25 + 0.5 * re
    # Glass draws once when not in total internal reflection.
    rng_g, u_g = lcg_next(torch.where(is_diffuse, rng_d2, rng))
    pick_refl = u_g < p
    glass_dir = torch.where((tir | pick_refl)[..., None], refl_dir, tdir)
    glass_weight = torch.where(
        tir, 1.0, torch.where(pick_refl, re / p, tr / (1.0 - p)))

    # Advance each lane's RNG by what it consumed.
    rng = torch.where(is_diffuse, rng_d2,
                      torch.where(is_glass & ~tir, rng_g, rng))

    new_dir = torch.where(is_diffuse[..., None], dir_diffuse,
                          torch.where(is_glass[..., None], glass_dir,
                                      dir_mirror))
    weight = torch.where(is_glass, glass_weight, 1.0)
    throughput = torch.where(live[..., None],
                             throughput * f * weight[..., None], throughput)

    # Terminate lanes whose throughput died.
    live = live & (torch.amax(throughput, dim=-1) > 0.0)

    # The new origin sits off the surface on the side the new direction
    # leaves through (refractions go through the surface).
    leave_side = torch.sign(dot(new_dir, norm, keepdims=True))
    new_origin = pos + norm * leave_side * ORIGIN_OFFSET
    return (new_origin, new_dir, throughput, radiance, rng, live)


def camera_frame(width: int, height: int, device):
    """The fixed SmallPT camera → (origin, unit direction, cx, cy), each a
    float32 [3] on ``device`` (smallpt.h:122-128)."""
    cam_o = torch.tensor(SMALLPT_CAM_ORIGIN, dtype=torch.float32,
                         device=device)
    cam_d = normalize(torch.tensor(SMALLPT_CAM_DIRECTION, dtype=torch.float32,
                                   device=device))
    cx = torch.tensor([width * 0.5135 / height, 0.0, 0.0],
                      dtype=torch.float32, device=device)
    cy = normalize(cross(cx, cam_d)) * 0.5135
    return cam_o, cam_d, cx, cy


def smallpt_camera_ray(u, v, width: int, height: int):
    """Camera ray for continuous image coordinates ``u``/``v`` in [0, 1)
    (u right, v up; tensors of any broadcastable shape) → (origin [..., 3],
    unit direction [..., 3]) (smallpt.h:122-141). Origins sit 140
    unnormalized-direction units down the ray, as in the reference."""
    cam_o, cam_d, cx, cy = camera_frame(width, height, u.device)
    u = u.to(torch.float32)
    v = v.to(torch.float32)
    d = cx * (u - 0.5)[..., None] + cy * (v - 0.5)[..., None] + cam_d
    return cam_o + d * 140.0, normalize(d)


def _initial_lane_state(x, y, width: int, height: int, accumulation: int):
    """Per-pixel initial bounce state for int64 pixel coords ``x``/``y``:
    the camera ray and the RNG chain seeded by jenkins(pixel-subsample
    index) ^ reverse_bits(frame) (smallpt.h:132-138). The dense renderer,
    the pooled wavefront and the megakernel all walk this chain."""
    accumulation = int(accumulation) & 0xFFFFFFFF
    sx = accumulation % 2
    sy = (accumulation >> 1) % 2
    index = u32((y * 2 + sy) * (width * 2) + x * 2 + sx)
    rng = jenkins_hash(index) ^ int(reverse_bits(u32(accumulation)))

    rng, u1 = lcg_next(rng)
    rng, u2 = lcg_next(rng)
    dx = _tent_jitter(u1)
    dy = _tent_jitter(u2)
    xf = x.to(torch.float32)
    yf = y.to(torch.float32)
    u = ((float(sx) + 0.5 + dx) / 2.0 + xf) / width
    v = ((float(sy) + 0.5 + dy) / 2.0 + yf) / height
    origin, direction = smallpt_camera_ray(u, v, width, height)
    return (origin, direction, torch.ones_like(origin),
            torch.zeros_like(origin), rng, torch.isfinite(origin[..., 0]))


def render_smallpt_pixels(scene: SphereScene, x, y, width: int, height: int,
                          accumulation: int):
    """One progressive sample for int64 pixel coords ``x``/``y`` (any
    broadcastable shape) → radiance [..., 3]."""
    state = _initial_lane_state(x, y, width, height, accumulation)
    for depth in range(MAX_DEPTH):
        state = _bounce(scene, state, depth)
    return state[3]


def render_smallpt_pooled_counted(scene: SphereScene, width: int, height: int,
                                  accumulation: int, pool_size: int = 131072):
    """Pooled compacting wavefront over the SmallPT estimator → (radiance
    [height·width, 3], live-ray tally [] int64).

    The same per-pixel sample chains as the dense renderer, but finished
    lanes are refilled with fresh camera rays at once, so no lane idles
    through the dense version's fixed ``MAX_DEPTH`` steps. The loop
    condition costs one host sync per step.
    """
    device = scene.position.device
    n_pixels = width * height
    r = min(pool_size, n_pixels)

    def spawn(pixel_idx):
        valid = pixel_idx < n_pixels
        safe = torch.clamp_max(pixel_idx, n_pixels - 1)
        o, d, thr, rad, rng, alive = _initial_lane_state(
            safe % width, safe // width, width, height, accumulation)
        return (o, d, thr, rad, rng, alive & valid)

    pixel_idx = torch.arange(r, dtype=torch.int64, device=device)
    state = spawn(pixel_idx)
    depth = torch.zeros(r, dtype=torch.int64, device=device)
    accum = torch.zeros((n_pixels, 3), device=device)
    next_pixel = torch.tensor(r, dtype=torch.int64, device=device)
    rays = torch.zeros((), dtype=torch.int64, device=device)
    max_iters = (n_pixels // r + 1) * MAX_DEPTH * 2 + 64

    for _ in range(max_iters):
        if not bool((state[5].any() | (next_pixel < n_pixels)).item()):
            break
        rays = rays + state[5].sum()
        o, d, thr, rad, rng, live = _bounce(scene, state, depth)
        depth = depth + 1
        live = live & (depth < MAX_DEPTH)    # the dense loop's hard cap
        done = (pixel_idx < n_pixels) & ~live

        accum.index_add_(0, torch.clamp_max(pixel_idx, n_pixels - 1),
                         torch.where(done[..., None], rad, 0.0))

        slot = torch.cumsum(done.to(torch.int64), dim=0) - 1
        new_idx = next_pixel + slot
        refill = done & (new_idx < n_pixels)
        pixel_idx = torch.where(refill, new_idx,
                                torch.where(done, n_pixels, pixel_idx))
        next_pixel = torch.clamp_max(next_pixel + done.sum(), n_pixels)

        fresh = spawn(pixel_idx)
        state = tuple(
            torch.where(refill.reshape(refill.shape + (1,) * (f.dim() - 1)),
                        f, s)
            for f, s in zip(fresh, (o, d, thr, rad, rng, live)))
        depth = torch.where(refill, 0, depth)
    return accum, rays


def render_smallpt_pooled(scene: SphereScene, width: int, height: int,
                          accumulation: int, pool_size: int = 131072):
    """One progressive SmallPT frame through the pooled wavefront →
    radiance [height, width, 3] (the chains of
    :func:`render_smallpt_accumulation`)."""
    accum, _ = render_smallpt_pooled_counted(scene, width, height,
                                             accumulation, pool_size)
    return accum.reshape(height, width, 3)


def pixel_grid(width: int, height: int, device):
    """int64 pixel coordinates (x, y), each [height, width]."""
    y, x = torch.meshgrid(torch.arange(height, device=device),
                          torch.arange(width, device=device), indexing="ij")
    return x, y


def render_smallpt_accumulation(scene: SphereScene, width: int, height: int,
                                accumulation: int):
    """One progressive sample per pixel → radiance [height, width, 3].

    ``accumulation`` is the 1-based progressive frame counter. Row 0 is the
    bottom row (smallpt's backbuffer convention).
    """
    x, y = pixel_grid(width, height, scene.position.device)
    return render_smallpt_pixels(scene, x, y, width, height, accumulation)


def render_smallpt(scene: SphereScene, width: int, height: int,
                   accumulations: int):
    """Progressive render: the running mean of ``accumulations`` frames
    (the lerp with 1/n of smallpt.h:144)."""
    buffer = torch.zeros((height, width, 3), device=scene.position.device)
    for n in range(1, accumulations + 1):
        frame = render_smallpt_accumulation(scene, width, height, n)
        buffer = buffer + (frame - buffer) / n
    return buffer
