"""Burley (Disney) diffuse BRDF with retroreflection.

Port of ``bifrost3d_tpu/bsdf/burley.py`` (``evaluate_scalar``,
``evaluate``, ``pdf``, ``evaluate_with_pdf``, ``sample``): the fd90 retro
term, the reference's fitted energy normalization, cosine-hemisphere
sampling.
"""

from __future__ import annotations

import torch

from bifrost3d_tpu_torch.bsdf.types import BSDFResponse, BSDFSample
from bifrost3d_tpu_torch.math.clip import maximum
from bifrost3d_tpu_torch.math.vec import lerp, normalize
from bifrost3d_tpu_torch.sampling.distributions import (
    INV_PI,
    cosine_hemisphere_pdf,
    cosine_hemisphere_sample,
)


def _pow5(x):
    x2 = x * x
    return x2 * x2 * x


def evaluate_scalar(roughness, wo, wi, halfway=None):
    if halfway is None:
        halfway = normalize(wo + wi)
    wi_dot_h = torch.sum(wi * halfway, dim=-1)
    fd90 = 0.5 + 2.0 * wi_dot_h * wi_dot_h * roughness
    f_wo = _pow5(maximum(1.0 - wo[..., 2], 0.0))
    f_wi = _pow5(maximum(1.0 - wi[..., 2], 0.0))
    # Burley is not energy conserving: the reference's fitted constant
    # (Burley.h:41).
    normalizer = 1.0 / lerp(0.969371021, 1.04337633, roughness)
    return lerp(1.0, fd90, f_wo) * lerp(1.0, fd90, f_wi) * INV_PI * normalizer


def evaluate(tint, roughness, wo, wi):
    return tint * evaluate_scalar(roughness, wo, wi)[..., None]


def pdf(roughness, wo, wi):
    return cosine_hemisphere_pdf(maximum(wi[..., 2], 0.0))


def evaluate_with_pdf(tint, roughness, wo, wi) -> BSDFResponse:
    return BSDFResponse(evaluate(tint, roughness, wo, wi),
                        pdf(roughness, wo, wi))


def sample(tint, roughness, wo, u2) -> BSDFSample:
    wi, p = cosine_hemisphere_sample(u2)
    return BSDFSample(
        direction=wi, pdf=p,
        is_delta=torch.zeros(p.shape, dtype=torch.bool, device=p.device),
        reflectance=evaluate(tint, roughness, wo, wi))
