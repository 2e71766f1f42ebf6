"""Precomputed rho lookup tables (energy-conservation fittings).

Port of the lookup side of ``bifrost3d_tpu/shading/fittings.py``
(``get_fittings``, ``_hat_weights``, ``_bilinear_2d``, ``sample_ggx_rho``,
``sample_ggx_with_fresnel_rho``). The tables are read by file path from the
JAX package's ``shading/data/fittings.npz`` with ``np.load``; the JAX
module is not imported and the table generators stay JAX-only.

Grid convention: value at index i corresponds to coordinate i/(n-1); the
lookup is bilinear through dense hat-function weight rows, as in JAX.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import torch

FITTINGS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "bifrost3d_tpu", "shading", "data", "fittings.npz")


class Fittings(NamedTuple):
    ggx: torch.Tensor               # [roughness, cos], specularity 1
    ggx_with_fresnel: torch.Tensor  # [roughness, cos], specularity 0


@functools.lru_cache(maxsize=None)
def get_fittings(device: torch.device) -> Fittings:
    """The GGX rho tables on ``device`` (read-only; loaded once per device)."""
    with np.load(FITTINGS_PATH) as data:
        return Fittings(**{
            k: torch.tensor(np.asarray(data[k], np.float32), device=device)
            for k in Fittings._fields})


def _hat_weights(coord, n: int):
    """Piecewise-linear interpolation weights [..., n] for coord in [0, 1]:
    w_i = max(0, 1 - |coord·(n-1) - i|)."""
    f = torch.clamp(coord, 0.0, 1.0) * (n - 1)
    idx = torch.arange(n, dtype=torch.float32, device=coord.device)
    return torch.clamp_min(1.0 - torch.abs(f[..., None] - idx), 0.0)


def _bilinear_2d(table, x, y):
    """table [ny, nx] at coords in [0, 1]: w_y · T · w_x."""
    wx = _hat_weights(x, table.shape[1])
    wy = _hat_weights(y, table.shape[0])
    return torch.sum((wy @ table) * wx, dim=-1)


def sample_ggx_rho(cos_theta, roughness, fittings: Fittings | None = None):
    f = fittings if fittings is not None else get_fittings(cos_theta.device)
    return _bilinear_2d(f.ggx, cos_theta, roughness)


def sample_ggx_with_fresnel_rho(cos_theta, roughness,
                                fittings: Fittings | None = None):
    f = fittings if fittings is not None else get_fittings(cos_theta.device)
    return _bilinear_2d(f.ggx_with_fresnel, cos_theta, roughness)
