"""EON energy-preserving Oren-Nayar diffuse BRDF.

Port of ``bifrost3d_tpu/bsdf/oren_nayar.py`` (``evaluate_scalar``,
``evaluate``, ``pdf``, ``evaluate_with_pdf``, ``sample``): single-scatter
FON plus colour-neutral multi-scatter compensation, sampled with a CLTC +
uniform-hemisphere mixture; evaluated at rho = 1 and tinted afterwards.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.frozen.bsdf.types import BSDFResponse, BSDFSample
from benchmark.reference.frozen.math.clip import clip, maximum
from benchmark.reference.frozen.sampling.distributions import (
    INV_PI,
    oren_nayar_cltc_pdf,
    oren_nayar_cltc_sample,
    uniform_hemisphere_sample,
)

_C1_FON = 0.5 - 2.0 / (3.0 * math.pi)
_C2_FON = 2.0 / 3.0 - 28.0 / (15.0 * math.pi)


def _e_fon_approx(cos_theta, roughness, a, b):
    """Quartic fit of the directional albedo E_FON (OrenNayar.h:42-49)."""
    mucomp = 1.0 - cos_theta
    g = torch.zeros_like(cos_theta)
    for coeff in (0.0714429953, -0.332181442, 0.491881867, 0.0571085289):
        g = mucomp * (coeff + g)
    return a + b * g


def evaluate_scalar(roughness, wo, wi):
    """Untinted EON BRDF value (rho = 1)."""
    cos_i, cos_o = wi[..., 2], wo[..., 2]
    s = torch.sum(wi * wo, dim=-1) - cos_i * cos_o
    s_over_t = torch.where(
        s > 0.0, s / maximum(torch.maximum(cos_i, cos_o), 1e-7), s)
    a = 1.0 / (1.0 + _C1_FON * roughness)
    b = roughness * a
    f_single = INV_PI * a * (1.0 + roughness * s_over_t)
    ef_o = _e_fon_approx(cos_o, roughness, a, b)
    ef_i = _e_fon_approx(cos_i, roughness, a, b)
    avg_ef = a * (1.0 + _C2_FON * roughness)
    f_multi = (INV_PI * torch.abs(1.0 - ef_o) * torch.abs(1.0 - ef_i)
               / maximum(1.0 - avg_ef, 1e-7))
    return f_single + f_multi


def evaluate(albedo, roughness, wo, wi):
    return albedo * evaluate_scalar(roughness, wo, wi)[..., None]


def _uniform_probability(roughness, cos_theta):
    """Fitted mixture weight between the uniform and CLTC lobes."""
    return torch.pow(maximum(roughness, 1e-7), 0.1) * (
        0.162925 + cos_theta * (-0.372058 + (0.538233 - 0.290822 * cos_theta)
                                * cos_theta))


def pdf(roughness, wo, wi):
    u_prob = _uniform_probability(roughness, wo[..., 2])
    cltc = oren_nayar_cltc_pdf(roughness, wo, wi)
    return u_prob * (0.5 * INV_PI) + (1.0 - u_prob) * cltc


def evaluate_with_pdf(albedo, roughness, wo, wi) -> BSDFResponse:
    return BSDFResponse(evaluate(albedo, roughness, wo, wi),
                        pdf(roughness, wo, wi))


def sample(albedo, roughness, wo, u2) -> BSDFSample:
    """Mixture-sample wi: both lobes evaluated, masked select."""
    u_prob = _uniform_probability(roughness, wo[..., 2])
    pick_uniform = u2[..., 0] <= u_prob
    ux_uniform = u2[..., 0] / maximum(u_prob, 1e-7)
    ux_cltc = (u2[..., 0] - u_prob) / maximum(1.0 - u_prob, 1e-7)
    ux = torch.where(pick_uniform, ux_uniform, ux_cltc)
    u2r = torch.stack([clip(ux, 0.0, 1.0 - 1e-7), u2[..., 1]], dim=-1)

    wi_uni, _ = uniform_hemisphere_sample(u2r)
    wi_cltc, _ = oren_nayar_cltc_sample(roughness, wo, u2r)
    wi = torch.where(pick_uniform[..., None], wi_uni, wi_cltc)
    return BSDFSample(
        direction=wi,
        pdf=pdf(roughness, wo, wi),
        is_delta=torch.zeros(wi.shape[:-1], dtype=torch.bool, device=wi.device),
        reflectance=evaluate(albedo, roughness, wo, wi))
