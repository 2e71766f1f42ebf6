"""Sphere / spot / directional light sampling, evaluation and PDFs.

Port of ``bifrost3d_tpu/lights/analytic.py`` (``_ray_sphere_t``,
``sphere_light_sample``/``_pdf``/``_evaluate``, ``spot_light_sample``/
``_pdf``/``_evaluate``, ``directional_light_sample``, ``sample_light``,
``light_pdf``, ``evaluate_light``, ``is_delta_light``): every light type is evaluated
branch-free and selected by its ``kind`` tag.
"""

from __future__ import annotations

import torch

from benchmark.reference.frozen.lights.types import (
    LIGHT_SPHERE,
    LIGHT_SPOT,
    LightArray,
    LightSample,
)
from benchmark.reference.frozen.math.clip import maximum
from benchmark.reference.frozen.math.vec import cross, dot, gsafe, length, normalize, to_world
from benchmark.reference.frozen.sampling.distributions import (
    PI,
    TWO_PI,
    concentric_disk_sample,
    cone_pdf,
    cone_sample,
)

# Subtended-angle threshold below which a sphere light becomes a point light.
_SMALL_SIN2 = 0.0
_MIN_SPOT_CONE = 1e-5


def _ray_sphere_t(origin, direction, center, radius):
    """Nearest positive intersection distance (-1 when missing)."""
    op = center - origin
    b = dot(op, direction)
    det = radius * radius - (dot(op, op) - b * b)
    sqrt_det = torch.sqrt(gsafe(det))
    t = torch.where(b - sqrt_det > 0, b - sqrt_det, b + sqrt_det)
    return torch.where((det >= 0) & (t > 0), t, -1.0)


# -- sphere -------------------------------------------------------------------

def sphere_light_sample(position, radius, power, lit_position, u2) -> LightSample:
    """Cone sampling of the subtended solid angle (SphereLightImpl.h:40-80)."""
    batch = torch.broadcast_shapes(lit_position.shape[:-1], radius.shape)
    radius = torch.broadcast_to(radius, batch)
    to_center = torch.broadcast_to(position - lit_position, batch + (3,))
    dist2 = dot(to_center, to_center)
    sin2 = radius * radius / maximum(dist2, 1e-10)
    is_point = sin2 <= _SMALL_SIN2

    cos_theta_max = torch.sqrt(gsafe(1.0 - sin2))
    cone_dir, cone_p = cone_sample(cos_theta_max, u2)
    direction = to_world(cone_dir, normalize(to_center))
    t = _ray_sphere_t(lit_position, direction, position, radius)
    t = torch.where(t <= 0.0, dot(to_center, direction), t)
    area = 4.0 * PI * radius * radius
    radiance_cone = power / maximum(PI * area, 1e-10)[..., None]

    dist = torch.sqrt(gsafe(dist2))
    radiance_point = power / (4.0 * PI * dist2)[..., None]
    dir_point = to_center / maximum(dist, 1e-10)[..., None]
    t_point = dist - radius

    pick = is_point[..., None]
    return LightSample(
        direction=torch.where(pick, dir_point, direction),
        distance=torch.where(is_point, t_point, t) * (1.0 - 1e-6),
        radiance=torch.where(pick, radiance_point, radiance_cone),
        pdf=torch.where(is_point, 1.0, cone_p),
        is_delta=torch.broadcast_to(is_point, cone_p.shape))


def sphere_light_pdf(position, radius, lit_position, direction):
    to_center = position - lit_position
    sin2 = radius * radius / maximum(dot(to_center, to_center), 1e-10)
    cos_theta_max = torch.sqrt(gsafe(1.0 - sin2))
    cos_theta = dot(direction, normalize(to_center))
    valid = (cos_theta >= cos_theta_max) & (sin2 > _SMALL_SIN2)
    return torch.where(valid, cone_pdf(cos_theta_max), 0.0)


def sphere_light_evaluate(position, radius, power, lit_position):
    """Radiance along any direction that hits the sphere."""
    area = 4.0 * PI * radius * radius
    return power / maximum(PI * area, 1e-10)[..., None]


# -- spot (disk) ----------------------------------------------------------------

def _ray_plane_t(origin, direction, point, normal):
    denom = dot(direction, normal)
    return dot(point - origin, normal) / torch.where(
        torch.abs(denom) > 1e-9, denom, 1e-9)


def spot_light_evaluate(position, radius, light_dir, cos_angle, power,
                        lit_position, direction):
    cos_theta = -dot(light_dir, direction)
    norm = TWO_PI * (1.0 - cos_angle)
    is_delta = radius == 0.0
    diff = position - lit_position
    d2 = torch.sum(diff * diff, dim=-1)
    area = PI * radius * radius
    norm = norm * torch.where(is_delta, d2, area * cos_theta)
    radiance = power / maximum(norm, 1e-10)[..., None]
    return torch.where((cos_theta > cos_angle)[..., None], radiance, 0.0)


def spot_light_sample(position, radius, light_dir, cos_angle, power,
                      lit_position, u2) -> LightSample:
    """Cone-or-disk sampling (SpotLightImpl.h:77-131), branch-free."""
    is_delta = radius == 0.0

    to_light = position - lit_position
    dist = length(to_light)
    dir_delta = to_light / maximum(dist, 1e-10)[..., None]

    t_plane = _ray_plane_t(lit_position, -light_dir, position, light_dir)
    cone_radius_at = t_plane * torch.sqrt(
        gsafe(1.0 - cos_angle * cos_angle)) / maximum(cos_angle, 1e-9)
    use_cone = (radius > cone_radius_at) & (cos_angle > _MIN_SPOT_CONE)

    cone_dir, cone_p = cone_sample(cos_angle, u2)
    dir_cone = -to_world(cone_dir, light_dir)
    t_cone = _ray_plane_t(lit_position, dir_cone, position, light_dir)
    off = lit_position + dir_cone * t_cone[..., None] - position
    on_light = torch.sum(off * off, dim=-1) < radius * radius
    rad_cone = torch.where(on_light[..., None], spot_light_evaluate(
        position, radius, light_dir, cos_angle, power, lit_position,
        dir_cone), 0.0)

    xy, disk_p = concentric_disk_sample(u2, maximum(radius, 1e-9))
    x_major = torch.abs(light_dir[..., 0]) > 0.9
    helper = torch.stack([torch.where(x_major, 0.0, 1.0),
                          torch.where(x_major, 1.0, 0.0),
                          torch.zeros_like(light_dir[..., 0])], dim=-1)
    tangent = normalize(cross(helper, light_dir))
    bitangent = cross(light_dir, tangent)
    sampled = position + xy[..., 0:1] * tangent + xy[..., 1:2] * bitangent
    to_s = sampled - lit_position
    dist_disk = length(to_s)
    dir_disk = to_s / maximum(dist_disk, 1e-10)[..., None]
    cos_theta_disk = -dot(light_dir, dir_disk)
    pdf_disk = (disk_p * dist_disk * dist_disk
                / maximum(cos_theta_disk, 1e-9))
    rad_disk = spot_light_evaluate(position, radius, light_dir, cos_angle,
                                   power, lit_position, dir_disk)

    use_cone_b = use_cone & ~is_delta
    direction = torch.where(is_delta[..., None], dir_delta,
                            torch.where(use_cone_b[..., None], dir_cone,
                                        dir_disk))
    distance = torch.where(is_delta, dist,
                           torch.where(use_cone_b, t_cone, dist_disk)) * (1.0 - 1e-6)
    radiance = torch.where(is_delta[..., None], spot_light_evaluate(
        position, radius, light_dir, cos_angle, power, lit_position,
        dir_delta), torch.where(use_cone_b[..., None], rad_cone, rad_disk))
    pdf = torch.where(is_delta, 1.0, torch.where(use_cone_b, cone_p, pdf_disk))
    return LightSample(direction=direction, distance=distance,
                       radiance=radiance, pdf=pdf,
                       is_delta=torch.broadcast_to(is_delta, pdf.shape))


def spot_light_pdf(position, radius, light_dir, cos_angle, lit_position,
                   direction):
    cos_theta = -dot(light_dir, direction)
    t_plane = _ray_plane_t(lit_position, -light_dir, position, light_dir)
    cone_radius_at = t_plane * torch.sqrt(
        gsafe(1.0 - cos_angle * cos_angle)) / maximum(cos_angle, 1e-9)
    use_cone = (radius > cone_radius_at) & (cos_angle > _MIN_SPOT_CONE)
    pdf_cone = cone_pdf(cos_angle)
    t = _ray_plane_t(lit_position, direction, position, light_dir)
    off = lit_position + direction * t[..., None] - position
    on_disk = (t >= 0.0) & (torch.sum(off * off, dim=-1) < radius * radius)
    pdf_disk = torch.where(
        on_disk,
        (1.0 / (PI * maximum(radius * radius, 1e-18)))
        * t * t / maximum(cos_theta, 1e-9), 0.0)
    valid = (cos_theta > 0.0) & (radius > 0.0)
    return torch.where(valid, torch.where(use_cone, pdf_cone, pdf_disk), 0.0)


# -- directional ----------------------------------------------------------------

def directional_light_sample(light_dir, radiance, shape) -> LightSample:
    direction = torch.broadcast_to(-light_dir, shape + (3,))
    like = dict(dtype=light_dir.dtype, device=light_dir.device)
    return LightSample(
        direction=direction,
        distance=torch.full(shape, 1e30, **like),
        radiance=torch.broadcast_to(radiance, shape + (3,)),
        pdf=torch.ones(shape, **like),
        is_delta=torch.ones(shape, dtype=torch.bool, device=light_dir.device))


# -- tagged dispatch over a LightArray ----------------------------------------

def _fields(lights: LightArray, index):
    index = index.long()
    return (lights.kind[index], lights.position[index], lights.radius[index],
            lights.power[index], lights.direction[index],
            lights.cos_angle[index])


def sample_light(lights: LightArray, index, lit_position, u2) -> LightSample:
    """Sample light ``index`` ([...] int) as seen from ``lit_position``."""
    kind, pos, radius, power, ldir, cos_angle = _fields(lights, index)
    s_sphere = sphere_light_sample(pos, radius, power, lit_position, u2)
    s_spot = spot_light_sample(pos, radius, ldir, cos_angle, power,
                               lit_position, u2)
    s_dir = directional_light_sample(ldir, power, shape=tuple(kind.shape))

    def pick(a, b, c):
        k = kind[..., None] if a.dim() > kind.dim() else kind
        return torch.where(k == LIGHT_SPHERE, a,
                           torch.where(k == LIGHT_SPOT, b, c))

    return LightSample(*(pick(a, b, c)
                         for a, b, c in zip(s_sphere, s_spot, s_dir)))


def light_pdf(lights: LightArray, index, lit_position, direction):
    """Solid-angle pdf of sampling ``direction`` from light ``index``
    (0 for delta lights) — the MIS denominator."""
    kind, pos, radius, _, ldir, cos_angle = _fields(lights, index)
    p_sphere = sphere_light_pdf(pos, radius, lit_position, direction)
    p_spot = spot_light_pdf(pos, radius, ldir, cos_angle, lit_position,
                            direction)
    return torch.where(kind == LIGHT_SPHERE, p_sphere,
                       torch.where(kind == LIGHT_SPOT, p_spot, 0.0))


def evaluate_light(lights: LightArray, index, lit_position, direction):
    """Radiance from light ``index`` along ``direction``."""
    kind, pos, radius, power, ldir, cos_angle = _fields(lights, index)
    e_sphere = sphere_light_evaluate(pos, radius, power, lit_position)
    e_spot = spot_light_evaluate(pos, radius, ldir, cos_angle, power,
                                 lit_position, direction)
    k = kind[..., None]
    return torch.where(k == LIGHT_SPHERE, e_sphere,
                       torch.where(k == LIGHT_SPOT, e_spot, 0.0))


def is_delta_light(lights: LightArray, index, lit_position):
    """True where light ``index`` acts as a delta light from
    ``lit_position``: a sphere subtending no angle, a spot of radius 0, or
    a directional light."""
    kind = lights.kind[index]
    radius = lights.radius[index]
    pos = lights.position[index]
    sphere_delta = (radius * radius / maximum(
        torch.sum(torch.square(pos - lit_position), dim=-1), 1e-10)
    ) <= _SMALL_SIN2
    return torch.where(kind == LIGHT_SPHERE, sphere_delta,
                       torch.where(kind == LIGHT_SPOT, radius == 0.0, True))
