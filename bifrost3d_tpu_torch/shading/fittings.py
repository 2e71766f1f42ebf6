"""Precomputed rho lookup tables (energy-conservation fittings).

Port of the lookup side of ``bifrost3d_tpu/shading/fittings.py``
(``get_fittings``, ``_hat_weights``, ``_bilinear_2d``, ``sample_ggx_rho``,
``sample_ggx_with_fresnel_rho``, ``sample_burley_rho``,
``sample_dielectric_ggx_rho``, ``_bilinear_2d_batch``, ``encode_pdf``,
``estimate_ggx_alpha_from_max_pdf``). The tables are read by file path from the
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

from bifrost3d_tpu_torch.math.clip import absolute, clip, maximum, minimum

FITTINGS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "bifrost3d_tpu", "shading", "data", "fittings.npz")


# The dielectric tables' IOR ranges (JAX fittings.py:48-52).
_IOR_OFFSET = 0.01666667
MIN_DENSE_IOR = 1.25 + _IOR_OFFSET
MAX_DENSE_IOR = 3.0 + _IOR_OFFSET
MIN_LIGHT_IOR = 1.0 / MAX_DENSE_IOR
MAX_LIGHT_IOR = 1.0 / MIN_DENSE_IOR


class Fittings(NamedTuple):
    ggx: torch.Tensor               # [roughness, cos], specularity 1
    ggx_with_fresnel: torch.Tensor  # [roughness, cos], specularity 0
    burley: torch.Tensor            # [roughness, cos]
    dielectric_light: torch.Tensor  # [ior, roughness, cos, 2]
    dielectric_dense: torch.Tensor  # [ior, roughness, cos, 2]
    bounded_vndf_alpha: torch.Tensor  # [cos, encoded max pdf]


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
    f = clip(coord, 0.0, 1.0) * (n - 1)
    idx = torch.arange(n, dtype=torch.float32, device=coord.device)
    return maximum(1.0 - absolute(f[..., None] - idx), 0.0)


def _bilinear_2d(table, x, y):
    """table [ny, nx] at coords in [0, 1]: w_y · T · w_x."""
    wx = _hat_weights(x, table.shape[1])
    wy = _hat_weights(y, table.shape[0])
    return torch.sum((wy @ table.to(wy.dtype)) * wx, dim=-1)


def sample_ggx_rho(cos_theta, roughness, fittings: Fittings | None = None):
    f = fittings if fittings is not None else get_fittings(cos_theta.device)
    return _bilinear_2d(f.ggx, cos_theta, roughness)


def sample_ggx_with_fresnel_rho(cos_theta, roughness,
                                fittings: Fittings | None = None):
    f = fittings if fittings is not None else get_fittings(cos_theta.device)
    return _bilinear_2d(f.ggx_with_fresnel, cos_theta, roughness)


def sample_burley_rho(cos_theta, roughness, fittings: Fittings | None = None):
    f = fittings if fittings is not None else get_fittings(cos_theta.device)
    return _bilinear_2d(f.burley, cos_theta, roughness)


def sample_dielectric_ggx_rho(cos_theta, roughness, ior_i_over_o,
                              fittings: Fittings | None = None):
    """→ (total_rho, reflected_rho), trilinear over the split IOR ranges
    (the light table below IOR 1, the dense one from 1)."""
    f = fittings if fittings is not None else get_fittings(cos_theta.device)
    ior = torch.as_tensor(ior_i_over_o, dtype=cos_theta.dtype,
                          device=cos_theta.device)
    t_light = clip((ior - MIN_LIGHT_IOR) / (MAX_LIGHT_IOR - MIN_LIGHT_IOR),
                   0.0, 1.0)
    t_dense = clip((ior - MIN_DENSE_IOR) / (MAX_DENSE_IOR - MIN_DENSE_IOR),
                   0.0, 1.0)

    def trilinear(table, t_ior):
        n = table.shape[0]
        fz = t_ior * (n - 1)
        z0 = torch.clamp(torch.floor(fz).to(torch.int32), 0, n - 2)
        tz = fz - z0
        lo = _bilinear_2d_batch(table, z0, cos_theta, roughness)
        hi = _bilinear_2d_batch(table, z0 + 1, cos_theta, roughness)
        return lo * (1 - tz)[..., None] + hi * tz[..., None]

    res = torch.where((ior >= 1.0)[..., None],
                      trilinear(f.dielectric_dense, t_dense),
                      trilinear(f.dielectric_light, t_light))
    return res[..., 0], res[..., 1]


def _hat_taps(coord, n: int):
    """The window of ``_hat_weights`` that can be nonzero or tie: indices
    floor(f) - 1 .. floor(f) + 1 (clamped, [..., 3]) and their weights
    max(0, 1 - |f - i|), zero for an index off the grid. Every weight
    outside the window is 0 with a zero gradient, so the window's sum is
    the dense row's value and gradient."""
    f = clip(coord, 0.0, 1.0) * (n - 1)
    idx = torch.floor(f.detach()).to(torch.int64)[..., None] + torch.arange(
        -1, 2, device=coord.device)
    on_grid = (idx >= 0) & (idx < n)
    w = maximum(1.0 - absolute(f[..., None] - idx.to(f.dtype)), 0.0)
    return idx.clamp(0, n - 1), torch.where(on_grid, w, 0.0)


def _bilinear_2d_batch(table, z, x, y):
    """table [nz, ny, nx, c] at a per-lane slice ``z`` and coords x, y in
    [0, 1] → [..., c]: JAX's one-hot z row and hat rows in x and y, here as
    a 3 × 3 gather of each lane's window (``_hat_taps``)."""
    z, x, y = torch.broadcast_tensors(z, x, y)
    ix, wx = _hat_taps(x, table.shape[2])
    iy, wy = _hat_taps(y, table.shape[1])
    taps = table.to(wx.dtype)[z.long()[..., None, None], iy[..., :, None],
                              ix[..., None, :]]           # [..., 3, 3, c]
    return torch.sum(wy[..., :, None, None] * wx[..., None, :, None] * taps,
                     dim=(-3, -2))


def encode_pdf(pdf):
    """Nonlinear PDF encoding (ShadingModels/Utils.h:104-130)."""
    non_linear = pdf / (1.0 + pdf)
    return minimum((non_linear - 0.13) / 0.87, 1.0)


def estimate_ggx_alpha_from_max_pdf(cos_theta, max_pdf,
                                    fittings: Fittings | None = None):
    """Minimum GGX alpha for path regularization (GGXMinimumRoughness):
    the smallest alpha whose peak bounded-VNDF reflection pdf at
    ``cos_theta`` stays below ``max_pdf``."""
    f = fittings if fittings is not None else get_fittings(cos_theta.device)
    return _bilinear_2d(f.bounded_vndf_alpha, encode_pdf(max_pdf), cos_theta)
