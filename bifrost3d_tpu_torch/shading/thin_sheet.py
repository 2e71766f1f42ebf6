"""Thin-sheet reflectance: light bouncing inside a thin-walled slab.

Port of ``bifrost3d_tpu/shading/thin_sheet.py`` (``ThinSheetThroughput``,
``refracted_cos_theta``, ``smooth_thin_sheet_reflectance``,
``approx_thin_sheet_reflectance``): the total reflected and transmitted
throughput of a thin dielectric sheet is the geometric series of internal
bounces,

    Re = R0 + T0·Ti·Ri / (1 - Ri²)        Te = T0·Ti / (1 - Ri²)

with R0/T0 the outside Fresnel terms and Ri/Ti the inside ones at the
refracted angle. The rough variant takes its Fresnel factors from the
dielectric GGX rho table.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bifrost3d_tpu_torch.bsdf.fresnel import (
    dielectric_schlick_fresnel,
    dielectric_specularity,
    schlick_fresnel,
)
from bifrost3d_tpu_torch.math.clip import maximum
from bifrost3d_tpu_torch.scene.materials import AIR_IOR
from bifrost3d_tpu_torch.shading.fittings import sample_dielectric_ggx_rho


class ThinSheetThroughput(NamedTuple):
    reflected: torch.Tensor    # [..., 3]
    transmitted: torch.Tensor  # [..., 3]


def refracted_cos_theta(abs_cos_theta, ior_i_over_o):
    """|cos| of the refracted direction for a ray entering at
    ``abs_cos_theta`` through a relative IOR, and whether it refracts (no
    total internal reflection); Utils.h:258-271."""
    inv = 1.0 / ior_i_over_o
    k = 1.0 - inv * inv * (1.0 - abs_cos_theta * abs_cos_theta)
    return torch.sqrt(maximum(k, 0.0)), k >= 0.0


def smooth_thin_sheet_reflectance(cos_theta_o, medium_ior,
                                  transmission_tint) -> ThinSheetThroughput:
    """Closed-form throughput of a smooth thin sheet
    (BSDFTestUtils.h:228-264). ``transmission_tint`` is the whole sheet's;
    each of its two surfaces contributes the square root."""
    specularity = dielectric_specularity(AIR_IOR, medium_ior)
    tint_per_side = torch.sqrt(torch.as_tensor(
        transmission_tint, dtype=cos_theta_o.dtype, device=cos_theta_o.device))
    refr_cos, valid = refracted_cos_theta(torch.abs(cos_theta_o),
                                          medium_ior / AIR_IOR)
    r0 = dielectric_schlick_fresnel(specularity, torch.abs(cos_theta_o),
                                    medium_ior / AIR_IOR)
    t0 = (1.0 - r0)[..., None] * tint_per_side
    ri = schlick_fresnel(specularity, refr_cos)
    ti = (1.0 - ri)[..., None] * tint_per_side

    series = 1.0 / (1.0 - ri * ri)
    reflected = r0[..., None] + (ri * series)[..., None] * t0 * ti
    transmitted = series[..., None] * t0 * ti
    return ThinSheetThroughput(
        reflected=torch.where(valid[..., None], reflected, 1.0),
        transmitted=torch.where(valid[..., None], transmitted, 0.0))


def approx_thin_sheet_reflectance(abs_cos_theta, roughness, ior_i_over_o,
                                  transmission_tint) -> ThinSheetThroughput:
    """Rough-sheet approximation (Utils.h:140-166): the smooth series with
    the Fresnel factors taken from the dielectric GGX rho table, divided
    by the total rho for the lobe's energy loss."""
    refr_cos, valid = refracted_cos_theta(abs_cos_theta, ior_i_over_o)

    total0, reflected0 = sample_dielectric_ggx_rho(
        abs_cos_theta, roughness, ior_i_over_o)
    r0 = reflected0 / maximum(total0, 1e-6)
    t0 = 1.0 - r0
    # The reference keeps the outside relative IOR for the inside fetch too
    # (Utils.h:153-155).
    totali, reflectedi = sample_dielectric_ggx_rho(
        refr_cos, roughness, ior_i_over_o)
    ri = reflectedi / maximum(totali, 1e-6)
    ti = 1.0 - ri

    t0ti = (t0 * ti)[..., None] * transmission_tint
    transmitted = t0ti / (1.0 - ri * ri)[..., None]
    reflected = r0[..., None] + ri[..., None] * transmitted
    return ThinSheetThroughput(
        reflected=torch.where(valid[..., None], reflected, 1.0),
        transmitted=torch.where(valid[..., None], transmitted, 0.0))
