"""Lambert cosine BRDF.

Port of ``bifrost3d_tpu/bsdf/lambert.py`` (``evaluate``, ``pdf``,
``evaluate_with_pdf``, ``sample``).
"""

from __future__ import annotations

import torch

from bifrost3d_tpu_torch.bsdf.types import BSDFResponse, BSDFSample
from bifrost3d_tpu_torch.math.clip import maximum
from bifrost3d_tpu_torch.sampling.distributions import (
    INV_PI,
    cosine_hemisphere_pdf,
    cosine_hemisphere_sample,
)


def evaluate(tint, wo=None, wi=None):
    return tint * INV_PI


def pdf(wo, wi):
    return cosine_hemisphere_pdf(maximum(wi[..., 2], 0.0))


def evaluate_with_pdf(tint, wo, wi) -> BSDFResponse:
    f = torch.broadcast_to(tint * INV_PI, wi.shape)
    return BSDFResponse(reflectance=f, pdf=pdf(wo, wi))


def sample(tint, wo, u2) -> BSDFSample:
    wi, p = cosine_hemisphere_sample(u2)
    return BSDFSample(
        direction=wi, pdf=p,
        is_delta=torch.zeros(p.shape, dtype=torch.bool, device=p.device),
        reflectance=torch.broadcast_to(tint * INV_PI, wi.shape))
