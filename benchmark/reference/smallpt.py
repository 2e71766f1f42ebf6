"""Plain PyTorch reference of SmallPT's progressive render.

Frozen from ``bifrost3d_tpu_torch`` at commit df1f774: the per-pixel
estimator of ``integrator/smallpt.py`` (``_tent_jitter``,
``_diffuse_dir``, ``_bounce``, ``camera_frame``, ``smallpt_camera_ray``,
``_initial_lane_state``) and ``scene/spheres.intersect_spheres``, which
the SmallPT megakernel follows term by term; the hashes and vector helpers
are the frozen copies under ``frozen/``. Nothing here imports the port:
the spheres, the camera, the path settings and the port's documented
departures from ``smallpt.h`` are read from the configuration's JSON.

Lanes are independent, so a lane is a (pixel, accumulation) pair: a
sample of pixels renders all its accumulations at once, in blocks, and the
running mean over them is the app's lerp ``buffer + (frame - buffer) / n``
in the app's order.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference.frozen.math.clip import maximum
from benchmark.reference.frozen.math.vec import cross, dot, normalize, reflect
from benchmark.reference.frozen.sampling.hashes import (
    jenkins_hash,
    lcg_next,
    reverse_bits,
    u32,
)

BSDF_DIFFUSE, BSDF_GLASS = 0, 2
_TWO_PI = 2.0 * math.pi


class Spheres(NamedTuple):
    position: torch.Tensor   # [n, 3]
    radius: torch.Tensor     # [n]
    emission: torch.Tensor   # [n, 3]
    color: torch.Tensor      # [n, 3]
    bsdf: torch.Tensor       # [n] int32


class Settings(NamedTuple):
    max_depth: int
    rr_start_depth: int
    eps: float
    origin_offset: float
    cam_origin: tuple
    cam_direction: tuple
    fov_scale: float
    ray_start: float


def spheres(config: dict, device) -> Spheres:
    """The configuration's ``spheres`` rows ([radius, position, emission,
    colour, bsdf]) as float32 / int32 tensors on ``device``."""
    rows = config["spheres"]

    def f32(i):
        return torch.tensor([r[i] for r in rows], dtype=torch.float32,
                            device=device)
    return Spheres(f32(1), f32(0), f32(2), f32(3),
                   torch.tensor([r[4] for r in rows], dtype=torch.int32,
                                device=device))


def settings(config: dict) -> Settings:
    """The path settings; a glass roulette that starts at a later depth
    than 0 (smallpt.h splits below depth 2) is refused: the estimator has
    the port's roulette at every depth only."""
    cam, dep = config["camera"], config["departures"]
    if int(dep["glass_rr_start_depth"]) != 0:
        raise ValueError("the reference takes the glass roulette at every "
                         "depth (glass_rr_start_depth 0) only")
    return Settings(int(config["max_depth"]), int(config["rr_start_depth"]),
                    float(dep["eps"]),
                    float(dep["origin_offset"]), tuple(cam["origin"]),
                    tuple(cam["direction"]), float(cam["fov_scale"]),
                    float(cam["ray_start"]))


def intersect(sph: Spheres, origin, direction, eps):
    """Nearest hit of rays [..., 3] → (t, index int32, hit mask): the stable
    (r - d_perp)(r + d_perp) discriminant, t = b - sqrt(det), else b +
    sqrt(det)."""
    op = sph.position - origin[..., None, :]
    b = torch.sum(op * direction[..., None, :], dim=-1)
    perp = op - b[..., None] * direction[..., None, :]
    perp2 = torch.sum(perp * perp, dim=-1)
    d_perp = torch.where(perp2 > 1e-12, torch.sqrt(perp2), 0.0)
    det = (sph.radius - d_perp) * (sph.radius + d_perp)
    sqrt_det = torch.sqrt(maximum(det, 0.0))
    t_near = b - sqrt_det
    t_far = b + sqrt_det
    inf = float("inf")
    t = torch.where(t_near > eps, t_near, torch.where(t_far > eps, t_far, inf))
    t = torch.where(det >= 0.0, t, inf)
    t_min, idx = torch.min(t, dim=-1)
    hit = torch.isfinite(t_min)
    return t_min, torch.where(hit, idx.to(torch.int32), -1), hit


def _tent_jitter(u):
    r = 2.0 * u
    return torch.where(r < 1.0, torch.sqrt(r) - 1.0,
                       1.0 - torch.sqrt(torch.clamp_min(2.0 - r, 0.0)))


def _diffuse_dir(nl, u1, u2):
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


def _bounce(sph: Spheres, st: Settings, state, depth: int):
    """One bounce of every lane. state = (origin, direction, throughput,
    radiance, rng, active)."""
    origin, direction, throughput, radiance, rng, active = state

    t, idx, hit = intersect(sph, origin, direction, st.eps)
    idx = torch.clamp_min(idx, 0).long()
    emission = sph.emission[idx]
    color = sph.color[idx]
    bsdf = sph.bsdf[idx]

    live = active & hit
    radiance = radiance + torch.where(live[..., None], throughput * emission,
                                      0.0)

    t_safe = torch.where(hit, t, 0.0)
    pos = origin + direction * t_safe[..., None]
    norm = normalize(pos - sph.position[idx])
    n_dot_d = dot(norm, direction)
    nl = torch.where(n_dot_d[..., None] < 0.0, norm, -norm)

    f = color
    max_refl = torch.amax(f, dim=-1)

    # Russian roulette once (depth + 1) > rr_start_depth, drawing only on
    # live hits.
    rr_on = depth + 1 > st.rr_start_depth
    rng_rr, u_rr = lcg_next(rng)
    if rr_on:
        rng = torch.where(live, rng_rr, rng)
        f = f / torch.clamp_min(max_refl, 1e-6)[..., None]
        live = live & (u_rr < max_refl)

    # Diffuse: cosine hemisphere sample (2 draws).
    is_diffuse = live & (bsdf == BSDF_DIFFUSE)
    rng_d1, u1 = lcg_next(rng)
    rng_d2, u2 = lcg_next(rng_d1)
    dir_diffuse = _diffuse_dir(nl, u1, u2)

    dir_mirror = reflect(direction, nl)

    # Glass: the Fresnel roulette between reflection and refraction, at
    # every depth.
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
    rng_g, u_g = lcg_next(torch.where(is_diffuse, rng_d2, rng))
    pick_refl = u_g < p
    glass_dir = torch.where((tir | pick_refl)[..., None], refl_dir, tdir)
    glass_weight = torch.where(
        tir, 1.0, torch.where(pick_refl, re / p, tr / (1.0 - p)))

    rng = torch.where(is_diffuse, rng_d2,
                      torch.where(is_glass & ~tir, rng_g, rng))

    new_dir = torch.where(is_diffuse[..., None], dir_diffuse,
                          torch.where(is_glass[..., None], glass_dir,
                                      dir_mirror))
    weight = torch.where(is_glass, glass_weight, 1.0)
    throughput = torch.where(live[..., None],
                             throughput * f * weight[..., None], throughput)
    live = live & (torch.amax(throughput, dim=-1) > 0.0)

    leave_side = torch.sign(dot(new_dir, norm, keepdims=True))
    new_origin = pos + norm * leave_side * st.origin_offset
    return (new_origin, new_dir, throughput, radiance, rng, live)


def camera_frame(st: Settings, width: int, height: int, device):
    """(origin, unit direction, cx, cy), each float32 [3] (smallpt.h:122-128)."""
    cam_o = torch.tensor(st.cam_origin, dtype=torch.float32, device=device)
    cam_d = normalize(torch.tensor(st.cam_direction, dtype=torch.float32,
                                   device=device))
    cx = torch.tensor([width * st.fov_scale / height, 0.0, 0.0],
                      dtype=torch.float32, device=device)
    cy = normalize(cross(cx, cam_d)) * st.fov_scale
    return cam_o, cam_d, cx, cy


def initial_state(st: Settings, x, y, width: int, height: int, accumulation):
    """Lanes' first state for int64 pixel coords ``x``/``y`` [p] and 1-based
    accumulations ``accumulation`` [p]: the tent-jittered camera ray and the
    LCG seeded by jenkins(2x2 sub-pixel index) ^ reverse_bits(frame)."""
    acc = u32(accumulation)
    sx = acc % 2
    sy = (acc >> 1) % 2
    index = u32((y * 2 + sy) * (width * 2) + x * 2 + sx)
    rng = jenkins_hash(index) ^ reverse_bits(acc)
    rng, u1 = lcg_next(rng)
    rng, u2 = lcg_next(rng)
    dx = _tent_jitter(u1)
    dy = _tent_jitter(u2)
    u = ((sx.to(torch.float32) + 0.5 + dx) / 2.0 + x.to(torch.float32)) / width
    v = ((sy.to(torch.float32) + 0.5 + dy) / 2.0 + y.to(torch.float32)) / height
    cam_o, cam_d, cx, cy = camera_frame(st, width, height, x.device)
    d = cx * (u - 0.5)[..., None] + cy * (v - 0.5)[..., None] + cam_d
    origin = cam_o + d * st.ray_start
    return (origin, normalize(d), torch.ones_like(origin),
            torch.zeros_like(origin), rng, torch.isfinite(origin[..., 0]))


def radiance(sph: Spheres, st: Settings, x, y, width: int, height: int,
             accumulation, counts=None, dtype=torch.float32):
    """One sample per lane → radiance [p, 3]. Each path's state (its ray,
    throughput and radiance) is held between bounces in ``dtype``. A
    ``counts`` dict, if given, receives ``bounces``: the live lanes
    entering each bounce, summed."""
    def held(state):
        return tuple(v.to(dtype) if v.is_floating_point() else v
                     for v in state)
    state = held(initial_state(st, x, y, width, height, accumulation))
    for depth in range(st.max_depth):
        if counts is not None:
            counts["bounces"] = counts.get("bounces", 0) + int(state[5].sum())
        state = held(_bounce(sph, st, state, depth))
    return state[3]


def render_pixels(config: dict, pixels, accumulations: int,
                  dtype=torch.float32, lanes_per_call: int = 1 << 18,
                  counts=None, first: int = 1):
    """The running mean of accumulations ``first`` .. ``first +
    accumulations - 1`` at flat pixel indices ``pixels`` [n] (row 0 at the
    bottom) → [n, 3] float32: each frame lerped in as ``buffer + (frame -
    buffer) / n``. ``dtype`` holds each path's state between bounces, the
    frames and the running mean: float32, as the configuration states; the
    control passes a lower precision (the scene and each bounce's
    arithmetic stay float32)."""
    device = pixels.device
    width, height = int(config["width"]), int(config["height"])
    sph, st = spheres(config, device), settings(config)
    n = pixels.numel()
    acc = torch.arange(first, first + accumulations, dtype=torch.int64,
                       device=device)
    px = pixels.repeat(accumulations)
    ak = acc.repeat_interleave(n)
    frames = torch.empty((accumulations * n, 3), dtype=torch.float32,
                         device=device)
    for s in range(0, px.numel(), lanes_per_call):
        sel = slice(s, s + lanes_per_call)
        frames[sel] = radiance(sph, st, px[sel] % width, px[sel] // width,
                               width, height, ak[sel], counts, dtype)
    frames = frames.reshape(accumulations, n, 3)
    buffer = torch.zeros((n, 3), dtype=dtype, device=device)
    for k in range(accumulations):
        buffer = buffer + (frames[k].to(dtype) - buffer) / (first + k)
    return buffer.to(torch.float32)
