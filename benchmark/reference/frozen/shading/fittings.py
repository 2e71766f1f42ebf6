"""The rho lookups of ``bifrost3d_tpu_torch/shading/fittings.py`` that the
Default shading model reads (``_hat_weights``, ``_bilinear_2d``,
``sample_ggx_rho``, ``sample_ggx_with_fresnel_rho``, ``encode_pdf``,
``estimate_ggx_alpha_from_max_pdf``), frozen, with the three tables they
read copied into ``benchmark/reference/data/fittings.npz``."""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.frozen.math.clip import absolute, clip, maximum, minimum

FITTINGS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "data", "fittings.npz")


class Fittings(NamedTuple):
    ggx: torch.Tensor               # [roughness, cos], specularity 1
    ggx_with_fresnel: torch.Tensor  # [roughness, cos], specularity 0
    bounded_vndf_alpha: torch.Tensor  # [cos, encoded max pdf]


@functools.lru_cache(maxsize=None)
def get_fittings(device: torch.device) -> Fittings:
    with np.load(FITTINGS_PATH) as data:
        return Fittings(**{
            k: torch.tensor(np.asarray(data[k], np.float32), device=device)
            for k in Fittings._fields})


def _hat_weights(coord, n: int):
    f = clip(coord, 0.0, 1.0) * (n - 1)
    idx = torch.arange(n, dtype=torch.float32, device=coord.device)
    return maximum(1.0 - absolute(f[..., None] - idx), 0.0)


def _bilinear_2d(table, x, y):
    wx = _hat_weights(x, table.shape[1])
    wy = _hat_weights(y, table.shape[0])
    return torch.sum((wy @ table.to(wy.dtype)) * wx, dim=-1)


def sample_ggx_rho(cos_theta, roughness):
    return _bilinear_2d(get_fittings(cos_theta.device).ggx, cos_theta,
                        roughness)


def sample_ggx_with_fresnel_rho(cos_theta, roughness):
    return _bilinear_2d(get_fittings(cos_theta.device).ggx_with_fresnel,
                        cos_theta, roughness)


def encode_pdf(pdf):
    non_linear = pdf / (1.0 + pdf)
    return minimum((non_linear - 0.13) / 0.87, 1.0)


def estimate_ggx_alpha_from_max_pdf(cos_theta, max_pdf):
    return _bilinear_2d(get_fittings(cos_theta.device).bounded_vndf_alpha,
                        encode_pdf(max_pdf), cos_theta)
