"""Gaussian bloom: thresholded separable blur added back to the image.

Port of ``bifrost3d_tpu/post/bloom.py`` (``_gaussian_kernel``,
``_blur_axis``, ``gaussian_bloom``). The dual-kawase variant is not on the
slice.
"""

from __future__ import annotations

import numpy as np
import torch


def _gaussian_kernel(std_dev: float, device) -> torch.Tensor:
    radius = max(1, int(np.ceil(3.0 * std_dev)))
    xs = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (xs / max(std_dev, 1e-6)) ** 2)
    return torch.as_tensor((k / k.sum()).astype(np.float32), device=device)


def _blur_axis(image, kernel, axis):
    """Separable 1D blur of [h, w, 3] along ``axis`` with edge padding."""
    pad = kernel.shape[0] // 2
    moved = torch.movedim(image, axis, 0)
    n = moved.shape[0]
    idx = torch.clamp(torch.arange(n, device=image.device)[:, None]
                      + torch.arange(kernel.shape[0], device=image.device)[None, :]
                      - pad, 0, n - 1)
    out = torch.einsum("nkwc,k->nwc", moved[idx], kernel)
    return torch.movedim(out, 0, axis)


def gaussian_bloom(image, threshold: float, support: float):
    """High-pass at ``threshold``, blur with std = support·height/4, add
    back. An infinite threshold disables bloom (the default)."""
    if not np.isfinite(threshold) or support <= 0.0:
        return image
    std_dev = support * image.shape[0] * 0.25
    kernel = _gaussian_kernel(std_dev, image.device)
    high = torch.clamp_min(image - threshold, 0.0)
    base = image - high
    return base + _blur_axis(_blur_axis(high, kernel, 0), kernel, 1)
