"""Fresnel terms and specularity ↔ index-of-refraction conversions.

Port of ``bifrost3d_tpu/bsdf/fresnel.py`` (``schlick_fresnel``,
``dielectric_schlick_fresnel``, ``dielectric_specularity``, ``conductor_specularity``,
``dielectric_ior_from_specularity``, ``conductor_ior_from_specularity``,
``adjust_dielectric_specularity_to_exterior_medium``,
``adjust_conductor_specularity_to_exterior_medium``).
"""

from __future__ import annotations

import torch

from benchmark.reference.frozen.math.clip import maximum

COAT_SPECULARITY = 0.04
COAT_IOR = 1.5
AIR_IOR = 1.0


def schlick_fresnel(specularity, abs_cos_theta):
    """Schlick approximation; specularity broadcasts (scalar or RGB)."""
    x = maximum(1.0 - abs_cos_theta, 0.0)
    x2 = x * x
    t = x2 * x2 * x
    return (1.0 - t) * specularity + t


def dielectric_schlick_fresnel(specularity, abs_cos_theta, ior_i_over_o):
    """Schlick with total internal reflection → 1 (Utils.h:190-204).

    ``abs_cos_theta`` must be non-negative and ``ior_i_over_o`` adjusted to
    the side being hit."""
    sin2 = 1.0 - abs_cos_theta * abs_cos_theta
    tir = sin2 >= ior_i_over_o * ior_i_over_o
    return torch.where(tir, 1.0, schlick_fresnel(specularity, abs_cos_theta))


def dielectric_specularity(ior_o, ior_i):
    """Normal-incidence reflectance between two dielectrics."""
    r = (ior_o - ior_i) / (ior_o + ior_i)
    return r * r


def conductor_specularity(ior_o, ior_i, ext_i):
    ext2 = ext_i * ext_i
    return (((ior_o - ior_i) ** 2 + ext2)
            / ((ior_o + ior_i) ** 2 + ext2))


def dielectric_ior_from_specularity(specularity):
    """Inverse of dielectric_specularity with ior_o = 1."""
    return 2.0 / (1.0 - torch.sqrt(specularity)) - 1.0


def conductor_ior_from_specularity(specularity, ext_i):
    a = specularity - 1.0
    b = 2.0 * specularity + 2.0
    c = a + (specularity - 1.0) * ext_i * ext_i
    d = b * b - 4.0 * a * c
    return (-b + torch.sqrt(maximum(d, 0.0))) / (2.0 * a)


def adjust_dielectric_specularity_to_exterior_medium(exterior_ior,
                                                     specularity_through_air):
    """Re-base an air-relative specularity to another exterior medium."""
    base_ior = dielectric_ior_from_specularity(specularity_through_air)
    return dielectric_specularity(exterior_ior, base_ior)


def adjust_conductor_specularity_to_exterior_medium(
        exterior_ior, specularity_through_air, extinction_coefficient):
    base_ior = conductor_ior_from_specularity(
        specularity_through_air, extinction_coefficient)
    return conductor_specularity(exterior_ior, base_ior, extinction_coefficient)
