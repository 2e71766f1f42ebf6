"""Linearly transformed cosines (Heitz et al. 2016).

Port of ``bifrost3d_tpu/math/ltc.py``: the reference's ``Math/LTC.h``
(IsotropicLTC, the 5-parameter inverse-M representation, ``LTC.h:25-56``)
and the analytic fits of ``Assets/Shading/LinearlyTransformedCosines.h``
(Lambert's identity, the EON Oren-Nayar fit of Portsmouth et al. 2025,
Listing 2). The GGX reflection table lives in
:mod:`bifrost3d_tpu_torch.shading.ltc_fit`.

An LTC is a NamedTuple of tensors, so a batch of LTCs (an image, a fit
grid) evaluates as one batch; M is inverted in closed form (the x-z
coupled structure has a 5-term inverse).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bifrost3d_tpu_torch.math.clip import absolute, maximum

_EPS = 1e-20
_INV_PI = 0.3183098861837907


# Local cosine-lobe sampling, as JAX's: the math layer sits below
# sampling, so this does not import sampling.distributions.

def _cosine_pdf(abs_cos_theta):
    return abs_cos_theta * _INV_PI


def _cosine_sample(u2):
    r2 = u2[..., 0]
    r = torch.sqrt(maximum(1.0 - r2, 0.0))
    z = torch.sqrt(r2)
    phi = 2.0 * math.pi * u2[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


class IsotropicLTC(NamedTuple):
    """LTC over the cosine distribution with the isotropic inverse matrix

        inverse_M = [[m00, 0, m02],
                     [0,   m11, 0],
                     [m20, 0, m22]]

    (``Math/LTC.h:25-27``). The fields broadcast together."""

    m00: torch.Tensor
    m11: torch.Tensor
    m22: torch.Tensor
    m02: torch.Tensor
    m20: torch.Tensor

    @staticmethod
    def identity(device=None) -> "IsotropicLTC":
        one = torch.tensor(1.0, device=device)
        zero = torch.tensor(0.0, device=device)
        return IsotropicLTC(one, one, one, zero, zero)


def _safe(k):
    """k with |k| < 1e-20 moved to ±1e-20, keeping its sign."""
    return torch.where(absolute(k) < _EPS, torch.where(k < 0, -_EPS, _EPS), k)


def inverse_m_determinant(ltc: IsotropicLTC):
    """det(inverse_M) = m11·(m00·m22 − m02·m20) (``LTC.h:33``)."""
    return ltc.m11 * (ltc.m00 * ltc.m22 - ltc.m02 * ltc.m20)


def inverse_m_matrix(ltc: IsotropicLTC):
    """Dense [..., 3, 3] inverse_M, for tests and interop."""
    z = torch.zeros_like(ltc.m00 + ltc.m11)
    rows = [
        torch.stack([ltc.m00 + z, z, ltc.m02 + z], dim=-1),
        torch.stack([z, ltc.m11 + z, z], dim=-1),
        torch.stack([ltc.m20 + z, z, ltc.m22 + z], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def m_matrix(ltc: IsotropicLTC):
    """Dense [..., 3, 3] M = inverse(inverse_M) in closed form: for
    A = [[a,0,b],[0,c,0],[d,0,e]] with k = a·e − b·d,
    A⁻¹ = [[e/k, 0, −b/k], [0, 1/c, 0], [−d/k, 0, a/k]]."""
    a, c, e = ltc.m00, ltc.m11, ltc.m22
    b, d = ltc.m02, ltc.m20
    inv_k = 1.0 / _safe(a * e - b * d)
    z = torch.zeros_like(a + c)
    rows = [
        torch.stack([e * inv_k + z, z, -b * inv_k + z], dim=-1),
        torch.stack([z, 1.0 / c + z, z], dim=-1),
        torch.stack([-d * inv_k + z, z, a * inv_k + z], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def _apply_inverse_m(ltc: IsotropicLTC, w):
    """inverse_M @ w without the matrix."""
    x = ltc.m00 * w[..., 0] + ltc.m02 * w[..., 2]
    y = ltc.m11 * w[..., 1]
    zc = ltc.m20 * w[..., 0] + ltc.m22 * w[..., 2]
    return torch.stack(torch.broadcast_tensors(x, y, zc), dim=-1)


def _apply_m(ltc: IsotropicLTC, w):
    """M @ w in closed form (see :func:`m_matrix`)."""
    a, c, e = ltc.m00, ltc.m11, ltc.m22
    b, d = ltc.m02, ltc.m20
    inv_k = 1.0 / _safe(a * e - b * d)
    x = (e * w[..., 0] - b * w[..., 2]) * inv_k
    y = w[..., 1] / c
    zc = (-d * w[..., 0] + a * w[..., 2]) * inv_k
    return torch.stack(torch.broadcast_tensors(x, y, zc), dim=-1)


def pdf(ltc: IsotropicLTC, w):
    """Density of the transformed cosine lobe at direction ``w``
    (``LTC.h:35-44``): pull ``w`` back through inverse_M, evaluate the
    cosine density of the normalized original direction, scale by the
    reciprocal Jacobian of normalization and transform (with |det|, as
    JAX's, so any parameters give a density)."""
    w_original_scaled = _apply_inverse_m(ltc, w)
    inv_len = 1.0 / torch.sqrt(maximum(
        torch.sum(w_original_scaled * w_original_scaled, dim=-1), _EPS))
    reciprocal_jacobian = inv_len ** 3 * absolute(inverse_m_determinant(ltc))
    original_cos_theta = maximum(w_original_scaled[..., 2] * inv_len, 0.0)
    return _cosine_pdf(original_cos_theta) * reciprocal_jacobian


def evaluate(ltc: IsotropicLTC, w):
    """An LTC is its own normalized distribution: evaluate == pdf
    (``LTC.h:46``)."""
    return pdf(ltc, w)


def sample(ltc: IsotropicLTC, u2):
    """Cosine-sample the original space, push through M, renormalize
    (``LTC.h:48-56``) → (direction, pdf)."""
    d = _apply_m(ltc, _cosine_sample(u2))
    inv_len = 1.0 / torch.sqrt(maximum(
        torch.sum(d * d, dim=-1, keepdim=True), _EPS))
    ltc_direction = d * inv_len
    return ltc_direction, pdf(ltc, ltc_direction)


# ---------------------------------------------------------------------------
# Analytic fits (Assets/Shading/LinearlyTransformedCosines.h)
# ---------------------------------------------------------------------------

def lambert_ltc_coefficients(device=None) -> IsotropicLTC:
    """Lambert is the (unclipped) cosine lobe itself: the identity fit."""
    return IsotropicLTC.identity(device)


def oren_nayar_ltc_coefficients(cos_theta_o, roughness) -> IsotropicLTC:
    """EON Oren-Nayar CLTC fit, Listing 2 of "EON: A Practical
    Energy-Preserving Rough Diffuse BRDF" (Portsmouth et al. 2025), the
    polynomial the reference embeds."""
    mu, r = torch.broadcast_tensors(torch.as_tensor(cos_theta_o),
                                    torch.as_tensor(roughness))
    m00 = 1.0 + r * (0.303392 + (-0.518982 + 0.111709 * mu) * mu
                     + (-0.276266 + 0.335918 * mu) * r)
    m02 = r * (-1.16407 + 1.15859 * mu
               + (0.150815 - 0.150105 * mu) * r) / (mu * mu * mu - 1.43545)
    m11 = 1.0 + r * (0.20013 + (-0.506373 + 0.261777 * mu) * mu)
    m20 = r * (0.540852 + (-1.01625 + 0.475392 * mu) * mu) \
        / (-1.0743 + (0.0725628 + mu) * mu)
    return IsotropicLTC(m00=m00, m11=m11, m22=torch.ones_like(m00), m02=m02,
                        m20=m20)
