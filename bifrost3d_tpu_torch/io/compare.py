"""Image comparison: RMS, SSIM, windowed MSSIM.

Port of ``bifrost3d_tpu/io/compare.py`` (``rms``, ``ssim``, ``mssim``), the
counterpart of the reference's ``ImageOperations/Compare.h:23-184``: RMS of
per-pixel |error| luminance, SSIM over whole-image statistics, MSSIM over
Gaussian-weighted windows. Images are numpy arrays or tensors [h, w, 3];
``rms`` and ``ssim`` run in float32, as the JAX package's, and ``mssim``
sums its windows in float64 and takes the luminance of the SSIM map in
float32, as the JAX package's; float64 images run all of it in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from bifrost3d_tpu_torch.math.color import luminance

_C1 = 0.01
_C2 = 0.03


def _tensor(image, dtype=None):
    t = image if isinstance(image, torch.Tensor) else torch.from_numpy(
        np.asarray(image))
    t = t.detach().cpu()
    if dtype is not None:
        return t.to(dtype)
    return t if t.is_floating_point() else t.to(torch.float32)


def rms(reference, target) -> float:
    """sqrt(mean(luminance(|a - b|)²)) (Compare.h rms)."""
    err = torch.abs(_tensor(reference) - _tensor(target))
    l1 = luminance(err)
    return float(torch.sqrt(torch.mean(l1 * l1)))


def _ssim_from_stats(mu_a, mu_b, var_a, var_b, cov):
    return ((2.0 * mu_a * mu_b + _C1) * (2.0 * cov + _C2)
            / ((mu_a * mu_a + mu_b * mu_b + _C1) * (var_a + var_b + _C2)))


def ssim(reference, target) -> float:
    """Whole-image SSIM, the luminance of the per-channel indices."""
    a, b = _tensor(reference), _tensor(target)
    if a.dtype != torch.float64:
        a, b = a.to(torch.float32), b.to(torch.float32)
    mu_a = torch.mean(a, dim=(0, 1))
    mu_b = torch.mean(b, dim=(0, 1))
    var_a = torch.mean(a * a, dim=(0, 1)) - mu_a * mu_a
    var_b = torch.mean(b * b, dim=(0, 1)) - mu_b * mu_b
    cov = torch.mean(a * b, dim=(0, 1)) - mu_a * mu_b
    return float(luminance(_ssim_from_stats(mu_a, mu_b, var_a, var_b, cov)))


def mssim(reference, target, support: int = 5) -> float:
    """Mean of windowed SSIM with the reference's Gaussian weights: the
    reference's per-pixel double loop as weighted window sums (means,
    second moments, joint moment) over the same window (Compare.h:127-184).
    """
    wide = _tensor(reference).dtype == torch.float64
    a = _tensor(reference, torch.float64).numpy()
    b = _tensor(target, torch.float64).numpy()
    h, w = a.shape[:2]

    ys, xs = np.mgrid[-support + 1:support, -support + 1:support]
    dist2 = (xs / support) ** 2 + (ys / support) ** 2
    wv = 1.5 * 1.5
    # The reference's window literally, with its positive exponent
    # (Compare.h:158-160).
    kernel = np.exp(dist2 / (2.0 * wv)) / np.sqrt(2.0 * np.pi * wv)

    def wsum(img):
        """Weighted window sums with edge clipping (no padding weight)."""
        out = np.zeros_like(img)
        for dy in range(-support + 1, support):
            for dx in range(-support + 1, support):
                wgt = kernel[dy + support - 1, dx + support - 1]
                ys0, ys1 = max(0, -dy), min(h, h - dy)
                xs0, xs1 = max(0, -dx), min(w, w - dx)
                out[ys0:ys1, xs0:xs1] += wgt * img[ys0 + dy:ys1 + dy,
                                                   xs0 + dx:xs1 + dx]
        return out

    wsum_1 = wsum(np.ones((h, w, 1)))
    mu_a = wsum(a) / wsum_1
    mu_b = wsum(b) / wsum_1
    var_a = wsum(a * a) / wsum_1 - mu_a * mu_a
    var_b = wsum(b * b) / wsum_1 - mu_b * mu_b
    cov = wsum(a * b) / wsum_1 - mu_a * mu_b
    s = _ssim_from_stats(mu_a, mu_b, var_a, var_b, cov)
    lum = luminance(torch.from_numpy(s if wide else s.astype(np.float32)))
    lum = lum.numpy()
    return float(lum.mean())
