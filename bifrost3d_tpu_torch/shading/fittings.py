"""Precomputed rho lookup tables (energy-conservation fittings).

Port of ``bifrost3d_tpu/shading/fittings.py``: the lookups
(``get_fittings``, ``_hat_weights``, ``_bilinear_2d``, ``sample_ggx_rho``,
``sample_ggx_with_fresnel_rho``, ``sample_burley_rho``,
``sample_dielectric_ggx_rho``, ``_bilinear_2d_batch``, ``encode_pdf``,
``estimate_ggx_alpha_from_max_pdf``) and the generator
(``precompute_fittings`` with ``_tabulate_brdf_rho``,
``_tabulate_dielectric`` and ``_tabulate_bounded_vndf_alpha``): the
reference's ``apps/dev/MaterialPrecomputations``, Monte-Carlo integration
of the port's own BSDFs over a (cos θ × roughness) grid on the device, so
tables and BSDFs cannot drift apart. The lookups read the JAX package's
``shading/data/fittings.npz`` by path with ``np.load``; ``python -m
bifrost3d_tpu_torch.shading.fittings`` generates the tables on the card
and writes ``build/shading/fittings.npz``.

Grid convention: value at index i corresponds to coordinate i/(n-1); the
lookup is bilinear through dense hat-function weight rows, as in JAX.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from bifrost3d_tpu_torch.bsdf import burley as burley_bsdf
from bifrost3d_tpu_torch.bsdf import ggx
from bifrost3d_tpu_torch.bsdf.fresnel import dielectric_specularity
from bifrost3d_tpu_torch.math.clip import absolute, clip, maximum, minimum
from bifrost3d_tpu_torch.sampling.hashes import van_der_corput
from bifrost3d_tpu_torch.sampling.pmj import pmj02_bn_samples

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FITTINGS_PATH = os.path.join(_REPO, "bifrost3d_tpu", "shading", "data",
                             "fittings.npz")
BUILD_PATH = os.path.join(_REPO, "build", "shading", "fittings.npz")

ANGLE_SAMPLES = 32
ROUGHNESS_SAMPLES = 32
DIELECTRIC_SAMPLES = 16
MAX_PDF_SAMPLES = 32


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


# ---------------------------------------------------------------------------
# Generation
# ---------------------------------------------------------------------------

def _grid_wo(n_angles):
    cos_theta = np.maximum(1e-6, np.arange(n_angles) / (n_angles - 1)).astype(
        np.float32)
    sin_theta = np.sqrt(np.maximum(1.0 - cos_theta**2, 0.0))
    return np.stack([sin_theta, np.zeros_like(cos_theta), cos_theta],
                    -1), cos_theta


def _rho_weight(s):
    """f·|cos θ| / pdf of each sample, 0 where the pdf is ~0."""
    return torch.where(s.pdf > 1e-9,
                       s.reflectance[..., 0] * torch.abs(s.direction[..., 2])
                       / maximum(s.pdf, 1e-12), 0.0)


def _tabulate_brdf_rho(sample_fn, sample_count=4096, *, device):
    """rho[roughness, cos] = E[f·cos θ/pdf] with shared PMJ-BN samples, one
    batch over the whole (roughness × angle × sample) grid."""
    u2 = torch.tensor(pmj02_bn_samples(sample_count), device=device)
    wo_grid, _ = _grid_wo(ANGLE_SAMPLES)
    shape = (ROUGHNESS_SAMPLES, ANGLE_SAMPLES, sample_count)
    roughness = torch.arange(ROUGHNESS_SAMPLES, dtype=torch.float32,
                             device=device) / (ROUGHNESS_SAMPLES - 1)
    wo = torch.broadcast_to(torch.tensor(wo_grid, device=device)[
        None, :, None, :], shape + (3,))
    u = torch.broadcast_to(u2[None, None, :, :], shape + (2,))
    r = torch.broadcast_to(roughness[:, None, None], shape)
    return _rho_weight(sample_fn(r, wo, u)).mean(dim=-1).cpu().numpy()


def _tabulate_dielectric(sample_count=4096, *, device):
    """(total, reflected) rho of combined GGX over the two IOR ranges
    → (light [16, 16, 16, 2], dense [16, 16, 16, 2])."""
    n = DIELECTRIC_SAMPLES
    u2 = torch.tensor(pmj02_bn_samples(sample_count), device=device)
    u3 = torch.cat([u2, van_der_corput(
        torch.arange(sample_count, device=device), 0x9E3779B9)[:, None]],
        dim=-1)
    wo_grid, _ = _grid_wo(n)
    wo = torch.broadcast_to(torch.tensor(wo_grid, device=device)[
        None, :, None, :], (n, n, sample_count, 3))
    u = torch.broadcast_to(u3[None, None], (n, n, sample_count, 3))
    roughness = torch.arange(n, dtype=torch.float32,
                             device=device)[:, None, None] / (n - 1)
    alpha = ggx.alpha_from_roughness(roughness)

    def one_slice(ior, spec):
        """One IOR slice: [roughness, angle, samples] in one batch."""
        s = ggx.sample(alpha, torch.tensor(spec, device=device),
                       torch.tensor(ior, device=device), wo, u)
        w = _rho_weight(s)
        is_refl = s.direction[..., 2] * wo[..., 2] > 0
        return (torch.mean(w, dim=-1),
                torch.mean(torch.where(is_refl, w, 0.0), dim=-1))

    out = {}
    for name, (ior_lo, ior_hi) in (("light", (MIN_LIGHT_IOR, MAX_LIGHT_IOR)),
                                   ("dense", (MIN_DENSE_IOR, MAX_DENSE_IOR))):
        table = np.zeros((n, n, n, 2), np.float32)
        for zi in range(n):
            ior = ior_lo + (ior_hi - ior_lo) * zi / (n - 1)
            # Normal-incidence reflectance is symmetric in the media pair.
            spec = dielectric_specularity(1.0, ior)
            total, refl = one_slice(ior, spec)
            table[zi, :, :, 0] = total.cpu().numpy()
            table[zi, :, :, 1] = refl.cpu().numpy()
        out[name] = table
    return out["light"], out["dense"]


def _decode_pdf(encoded):
    non_linear = encoded * 0.87 + 0.13
    return non_linear / (1.0 - non_linear)


def _tabulate_bounded_vndf_alpha(*, device):
    """alpha[cos, encoded_pdf]: the smallest GGX alpha whose peak
    bounded-VNDF reflection pdf stays below the given max pdf (path
    regularization, apps/dev GGXAlphaFromMaxPDF.h), by 40 bisection
    steps."""
    wo_grid, _ = _grid_wo(ANGLE_SAMPLES)
    enc = torch.arange(MAX_PDF_SAMPLES, dtype=torch.float32,
                       device=device) / (MAX_PDF_SAMPLES - 1)
    target = _decode_pdf(enc)[None, :]                          # [1, p]
    shape = (ANGLE_SAMPLES, MAX_PDF_SAMPLES)
    wo = torch.tensor(wo_grid, device=device)[:, None, :]       # [a, 1, 3]
    mirror = torch.cat([-wo[..., :2], wo[..., 2:3]], dim=-1)
    wo, mirror = (torch.broadcast_to(v, shape + (3,)) for v in (wo, mirror))
    lo = torch.full(shape, ggx.MIN_ALPHA, device=device)
    hi = torch.ones(shape, device=device)
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        # The peak pdf falls as alpha grows: a peak too high raises alpha.
        too_sharp = ggx.r_pdf(mid, wo, mirror) > target
        lo, hi = torch.where(too_sharp, mid, lo), torch.where(too_sharp, hi,
                                                              mid)
    return (0.5 * (lo + hi)).cpu().numpy()


def precompute_fittings(sample_count=4096, save_path=BUILD_PATH, *,
                        device=None) -> Fittings:
    """Generate every table on ``device`` (the card by default) → Fittings
    on that device; written to ``save_path`` (``build/``) when one is
    given."""
    device = torch.device(device if device is not None else "cuda")

    def sample_ggx_full(roughness, wo, u2):
        return ggx.r_sample(ggx.alpha_from_roughness(roughness), 1.0, wo, u2)

    def sample_ggx_base(roughness, wo, u2):
        return ggx.r_sample(ggx.alpha_from_roughness(roughness), 0.0, wo, u2)

    def sample_burley(roughness, wo, u2):
        # The reference's precompute passes GGX alpha as Burley roughness
        # (MaterialPrecomputations main.cpp:45-48), as JAX's does.
        return burley_bsdf.sample(torch.ones(3, device=device),
                                  ggx.alpha_from_roughness(roughness), wo, u2)

    with torch.no_grad():
        tables = {
            "ggx": _tabulate_brdf_rho(sample_ggx_full, sample_count,
                                      device=device),
            "ggx_with_fresnel": _tabulate_brdf_rho(
                sample_ggx_base, sample_count, device=device),
            "burley": _tabulate_brdf_rho(sample_burley, sample_count,
                                         device=device),
        }
        tables["dielectric_light"], tables["dielectric_dense"] = \
            _tabulate_dielectric(sample_count, device=device)
        tables["bounded_vndf_alpha"] = _tabulate_bounded_vndf_alpha(
            device=device)
    if save_path:
        os.makedirs(os.path.dirname(save_path), exist_ok=True)
        np.savez_compressed(save_path, **tables)
    return Fittings(**{k: torch.tensor(v, device=device)
                       for k, v in tables.items()})


if __name__ == "__main__":
    import argparse
    import time

    parser = argparse.ArgumentParser(
        description="Generate the rho and bounded-VNDF fitting tables.")
    parser.add_argument("-o", "--output", default=BUILD_PATH)
    parser.add_argument("--samples", type=int, default=4096)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    t0 = time.time()
    precompute_fittings(args.samples, args.output, device=args.device)
    print(f"fittings written to {args.output} in {time.time() - t0:.1f}s")
