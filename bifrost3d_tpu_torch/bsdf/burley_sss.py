"""Burley normalized-diffusion BSSRDF (subsurface scattering profile).

Port of ``bifrost3d_tpu/bsdf/burley_sss.py``, the counterpart of
``Shading/BSDFs/BurleySSS.h``: Christensen & Burley 2015's approximate
reflectance profiles, with the exact analytic inversion of the profile's
CDF of Golubev 2019 (zero-radiance.github.io) and Karis' fast
approximation, over tensors of any shape.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bifrost3d_tpu_torch.math.clip import absolute, clip, maximum

PI = float(torch.tensor(math.pi, dtype=torch.float32))


class Parameters(NamedTuple):
    """Precomputed profile parameters (BurleySSS::Parameters)."""

    diffuse_albedo: torch.Tensor          # [..., 3]
    diffuse_mean_free_path: torch.Tensor  # [..., 3] = l / s

    @staticmethod
    def search_light_scaling(diffuse_albedo):
        """Eq. 5 of Approximate Reflectance Profiles (search-light)."""
        a = diffuse_albedo - 0.8
        return 1.85 - diffuse_albedo + 7.0 * absolute(a * a * a)

    @staticmethod
    def diffuse_light_scaling(diffuse_albedo):
        """Eq. 6 (diffuse-light)."""
        return 1.9 - diffuse_albedo + 3.5 * torch.square(diffuse_albedo - 0.8)

    @staticmethod
    def create(diffuse_albedo, mean_free_path, diffuse_light: bool = True):
        s = (Parameters.diffuse_light_scaling(diffuse_albedo) if diffuse_light
             else Parameters.search_light_scaling(diffuse_albedo))
        return Parameters(diffuse_albedo=diffuse_albedo,
                          diffuse_mean_free_path=mean_free_path / s)


def evaluate_profile(distance, diffuse_mean_free_path):
    """R(r), eq. 2: exp(-r/3d) + exp(-r/d) over 8π·d·r."""
    single = torch.exp(-distance / (3.0 * diffuse_mean_free_path))
    multi = single * single * single
    normalizer = 8.0 * PI * diffuse_mean_free_path * maximum(distance, 1e-8)
    return (single + multi) / normalizer


def evaluate(params: Parameters, po, pi):
    """Eq. 3: the albedo-weighted profile between entry and exit points."""
    r = torch.linalg.vector_norm(po - pi, dim=-1, keepdim=True)
    return params.diffuse_albedo * evaluate_profile(
        r, params.diffuse_mean_free_path)


def sample_diffusion_profile(u, diffuse_mean_free_path):
    """Exact analytic inversion of the polar CDF (Golubev 2019) → (radius,
    rcp_pdf), the pdf in cartesian measure (with the r Jacobian), as
    BurleySSS.h:92-115.

    Evaluated in float64 and returned in the inputs' dtype: near radius 0
    the formula cancels (c ≈ 4u inside log2(c / 4u)), where one float32
    ulp of c becomes hundreds of ulps of the radius."""
    dtype = torch.promote_types(torch.as_tensor(u).dtype,
                                torch.as_tensor(diffuse_mean_free_path).dtype)
    u = torch.as_tensor(u).double()
    log2_e = 1.44269504089
    u = clip(1.0 - u, 1e-7, 1.0)             # CDF → CCDF, nonzero
    g = 1.0 + (4.0 * u) * (2.0 * u + torch.sqrt(1.0 + (4.0 * u) * u))
    n = torch.exp2(torch.log2(g) * (-1.0 / 3.0))
    p = (g * n) * n
    c = 1.0 + p + n
    x = (3.0 / log2_e) * torch.log2(c / (4.0 * u))
    cc = c * c
    four_u = 4.0 * u
    rcp_exp = (cc * c) / (four_u * (cc + torch.square(four_u)))
    d = torch.as_tensor(diffuse_mean_free_path).double()
    radius = x * d
    rcp_pdf = (8.0 * PI * radius * d) * rcp_exp
    return radius.to(dtype), rcp_pdf.to(dtype)


def sample_diffusion_profile_approximation(u, diffuse_mean_free_path, c=2.6):
    """Karis' closed-form approximation (Xie et al. 2020; UE5 uses c=2.6)."""
    u = clip(u, 0.0, 1.0 - 1e-7)
    return diffuse_mean_free_path * ((2.0 - c) * u - 2.0) * torch.log(1.0 - u)
