"""GGX microfacet reflection (GGX_R).

Port of the reflection part of ``bifrost3d_tpu/bsdf/ggx.py``
(``alpha_from_roughness``, ``roughness_from_alpha``,
``effectively_smooth``, ``height_correlated_g``, ``r_evaluate``,
``r_pdf``, ``r_evaluate_with_pdf``, ``r_sample``): Walter 07 with Schlick
Fresnel, height-correlated Smith G and bounded-VNDF sampling; alpha =
roughness², and ``MIN_ALPHA`` = 1e-4 is a delta mirror. The transmission
lobes serve only the Transmissive model, which is not on the slice.
"""

from __future__ import annotations

import torch

from bifrost3d_tpu_torch.bsdf.fresnel import schlick_fresnel
from bifrost3d_tpu_torch.bsdf.types import BSDFResponse, BSDFSample
from bifrost3d_tpu_torch.math.vec import normalize
from bifrost3d_tpu_torch.sampling.distributions import (
    ggx_bounded_vndf_pdf,
    ggx_bounded_vndf_sample,
    ggx_lambda,
    ggx_ndf,
)

MIN_ALPHA = 1e-4


def alpha_from_roughness(roughness):
    return torch.clamp_min(roughness * roughness, MIN_ALPHA)


def roughness_from_alpha(alpha):
    return torch.sqrt(alpha)


def effectively_smooth(alpha):
    return alpha <= MIN_ALPHA


def height_correlated_g(alpha, wo, wi):
    """Height-correlated Smith masking-shadowing."""
    return 1.0 / (1.0 + ggx_lambda(alpha, wo) + ggx_lambda(alpha, wi))


def r_evaluate(alpha, specularity, wo, wi):
    """Rough reflection f; 0 when effectively smooth or cross-hemisphere."""
    same_hemi = wo[..., 2] * wi[..., 2] > 0.0
    valid = ~effectively_smooth(alpha) & same_hemi
    halfway = normalize(wo + wi)
    g = height_correlated_g(alpha, wo, wi)
    d = ggx_ndf(alpha, torch.abs(halfway[..., 2]))
    cos_oh = torch.abs(torch.sum(wo * halfway, dim=-1, keepdim=True))
    f = schlick_fresnel(specularity, cos_oh)
    denom = 4.0 * wo[..., 2] * wi[..., 2]
    val = f * (d * g / torch.where(torch.abs(denom) > 1e-10, denom, 1.0))[..., None]
    val = torch.broadcast_to(val, wo.shape)
    return torch.where(valid[..., None], val, 0.0)


def r_pdf(alpha, wo, wi):
    """Bounded-VNDF reflection pdf; 0 when smooth or cross-hemisphere.
    Invalid pairs are swapped for the mirror direction before the pdf math
    so masked lanes never produce inf/NaN."""
    same_hemi = wo[..., 2] * wi[..., 2] > 0.0
    mirror = torch.cat([-wo[..., :2], wo[..., 2:3]], dim=-1)
    wi_safe = torch.where(same_hemi[..., None], wi, mirror)
    p = ggx_bounded_vndf_pdf(alpha, wo, wi_safe)
    return torch.where(effectively_smooth(alpha) | ~same_hemi, 0.0, p)


def r_evaluate_with_pdf(alpha, specularity, wo, wi) -> BSDFResponse:
    return BSDFResponse(r_evaluate(alpha, specularity, wo, wi),
                        r_pdf(alpha, wo, wi))


def r_sample(alpha, specularity, wo, u2) -> BSDFSample:
    """Bounded VNDF for rough lobes, delta mirror when smooth."""
    smooth = effectively_smooth(alpha)
    wi_rough, pdf_rough = ggx_bounded_vndf_sample(alpha, wo, u2)
    f_rough = r_evaluate(alpha, specularity, wo, wi_rough)
    bad = wi_rough[..., 2] < 0.0
    pdf_rough = torch.where(bad, 0.0, pdf_rough)
    f_rough = torch.where(bad[..., None], 0.0, f_rough)
    wi_delta = torch.cat([-wo[..., :2], wo[..., 2:3]], dim=-1)
    abs_z = torch.clamp_min(torch.abs(wo[..., 2:3]), 1e-7)
    f_delta = schlick_fresnel(specularity, torch.abs(wo[..., 2:3]))
    f_delta = torch.broadcast_to(f_delta / abs_z, wi_delta.shape)

    smooth_b = torch.broadcast_to(smooth, pdf_rough.shape)
    return BSDFSample(
        direction=torch.where(smooth_b[..., None], wi_delta, wi_rough),
        pdf=torch.where(smooth_b, 1.0, pdf_rough),
        is_delta=smooth_b,
        reflectance=torch.where(smooth_b[..., None], f_delta, f_rough))
