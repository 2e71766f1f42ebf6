"""Analytic sphere scenes (SmallPT) as struct-of-arrays tensors.

Port of ``bifrost3d_tpu/scene/spheres.py`` (``SphereScene``,
``smallpt_scene``, ``smallvpt_scene``, ``intersect_spheres``): the classic
9-sphere Cornell box with diffuse, mirror and glass materials. The whole
scene broadcasts against the ray wavefront; intersection is one rays ×
spheres test.

The 1e5-radius wall spheres cancel catastrophically in float32
(b² - |op|² + r² mixes ~1e10 magnitudes), so the discriminant is taken in
the stable perpendicular-distance form det = (r - d⊥)(r + d⊥) with
d⊥ = |op - b·d|, which keeps the hit-distance error small enough for an
epsilon of 1e-2 scene units.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bifrost3d_tpu_torch.math.clip import maximum

BSDF_DIFFUSE = 0
BSDF_SPECULAR = 1
BSDF_GLASS = 2


class SphereScene(NamedTuple):
    position: torch.Tensor   # [n, 3]
    radius: torch.Tensor     # [n]
    emission: torch.Tensor   # [n, 3]
    color: torch.Tensor      # [n, 3]
    bsdf: torch.Tensor       # [n] int32: 0 diffuse, 1 mirror, 2 glass
    # Homogeneous scattering medium per sphere (smallvpt): extinction
    # sigma_t, single-scattering albedo, HG asymmetry g. sigma_t == 0 →
    # no medium.
    medium_sigma_t: torch.Tensor  # [n]
    medium_albedo: torch.Tensor   # [n]
    medium_g: torch.Tensor        # [n]


def sphere_scene_from_numpy(arrays: dict, *, device) -> SphereScene:
    """A SphereScene from its fields held as numpy arrays (``bsdf`` int32,
    everything else float32)."""
    return SphereScene(**{
        name: torch.tensor(np.asarray(
            arrays[name], np.int32 if name == "bsdf" else np.float32),
            device=device)
        for name in SphereScene._fields})


def _build(rows, device) -> SphereScene:
    med = [r[5] if len(r) > 5 else (0.0, 0.0, 0.0) for r in rows]
    med = np.asarray(med, np.float32)
    return sphere_scene_from_numpy(dict(
        position=[r[1] for r in rows], radius=[r[0] for r in rows],
        emission=[r[2] for r in rows], color=[r[3] for r in rows],
        bsdf=[r[4] for r in rows], medium_sigma_t=med[:, 0],
        medium_albedo=med[:, 1], medium_g=med[:, 2]), device=device)


def smallpt_scene(*, device) -> SphereScene:
    """The classic smallpt Cornell box (smallpt.h:47-57): six wall spheres,
    a mirror ball, a glass ball and a spherical ceiling light."""
    k = 1e5
    rows = [
        (k, (k + 1, 40.8, 81.6), (0, 0, 0), (0.75, 0.25, 0.25), BSDF_DIFFUSE),   # left
        (k, (-k + 99, 40.8, 81.6), (0, 0, 0), (0.25, 0.25, 0.75), BSDF_DIFFUSE),  # right
        (k, (50, 40.8, k), (0, 0, 0), (0.75, 0.75, 0.75), BSDF_DIFFUSE),          # back
        (k, (50, 40.8, -k + 170), (0, 0, 0), (0, 0, 0), BSDF_DIFFUSE),            # front
        (k, (50, k, 81.6), (0, 0, 0), (0.75, 0.75, 0.75), BSDF_DIFFUSE),          # bottom
        (k, (50, -k + 81.6, 81.6), (0, 0, 0), (0.75, 0.75, 0.75), BSDF_DIFFUSE),  # top
        (16.5, (27, 16.5, 47), (0, 0, 0), (0.999, 0.999, 0.999), BSDF_SPECULAR),  # mirror
        (16.5, (73, 16.5, 78), (0, 0, 0), (0.999, 0.999, 0.999), BSDF_GLASS),     # glass
        (600.0, (50, 681.6 - 0.27, 81.6), (12, 12, 12), (0, 0, 0), BSDF_DIFFUSE),  # light
    ]
    return _build(rows, device)


def smallvpt_scene(sigma_t=0.01, albedo=0.75, g=-0.5, *, device) -> SphereScene:
    """smallpt with the mirror ball replaced by a participating-medium
    sphere (smallvpt.h:59-60)."""
    scene = smallpt_scene(device=device)

    def with_row6(field, value):
        out = field.clone()
        out[6] = value
        return out

    return scene._replace(
        bsdf=with_row6(scene.bsdf, BSDF_DIFFUSE),
        color=with_row6(scene.color, 0.0),
        medium_sigma_t=with_row6(scene.medium_sigma_t, sigma_t),
        medium_albedo=with_row6(scene.medium_albedo, albedo),
        medium_g=with_row6(scene.medium_g, g))


def intersect_spheres(scene: SphereScene, origin, direction, eps=1e-2):
    """Nearest hit of rays [..., 3] against all spheres → (t [...], hit
    index [...] int32, hit mask [...]). Misses get t = inf, index -1. Root
    selection as in the double-precision reference: t = b - sqrt(det),
    else b + sqrt(det)."""
    op = scene.position - origin[..., None, :]             # [..., n, 3]
    b = torch.sum(op * direction[..., None, :], dim=-1)    # [..., n]
    perp = op - b[..., None] * direction[..., None, :]
    perp2 = torch.sum(perp * perp, dim=-1)
    d_perp = torch.where(perp2 > 1e-12, torch.sqrt(perp2), 0.0)
    det = (scene.radius - d_perp) * (scene.radius + d_perp)
    sqrt_det = torch.sqrt(maximum(det, 0.0))
    t_near = b - sqrt_det
    t_far = b + sqrt_det
    inf = float("inf")
    t = torch.where(t_near > eps, t_near, torch.where(t_far > eps, t_far, inf))
    t = torch.where(det >= 0.0, t, inf)
    t_min, idx = torch.min(t, dim=-1)
    hit = torch.isfinite(t_min)
    return t_min, torch.where(hit, idx.to(torch.int32), -1), hit
