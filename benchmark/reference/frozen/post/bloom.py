"""Bloom: a thresholded blur added back to the image.

Port of ``bifrost3d_tpu/post/bloom.py`` (``_gaussian_kernel``,
``_blur_axis``, ``gaussian_bloom``, ``_bilinear_sample``,
``_kawase_downsample``, ``_kawase_upsample``, ``dual_kawase_bloom``): the
separable Gaussian, and the dual-kawase pyramid of 5-tap half-resolution
downsamples and 8-tap upsamples (Bloom.hlsl:70-117) whose taps are
clamped bilinear fetches, as ``jax.scipy.ndimage.map_coordinates(order=1,
mode="nearest")`` makes them (the four corners summed in its order).
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


def _bilinear_sample(image, ys, xs):
    """Clamp-sampled bilinear fetch of [h, w, 3] at fractional pixel
    coords (the D3D clamp sampler of the kawase shaders)."""
    h, w = image.shape[0], image.shape[1]
    y0f = torch.floor(ys)
    x0f = torch.floor(xs)
    wy1 = (ys - y0f)[..., None]
    wx1 = (xs - x0f)[..., None]
    wy0 = 1 - wy1
    wx0 = 1 - wx1
    y0 = y0f.long()
    x0 = x0f.long()
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y0 = torch.clamp(y0, 0, h - 1)
    x0 = torch.clamp(x0, 0, w - 1)
    return (wy0 * wx0 * image[y0, x0] + wy0 * wx1 * image[y0, x1]
            + wy1 * wx0 * image[y1, x0] + wy1 * wx1 * image[y1, x1])


def _tap_grid(h, w, oh, ow, like):
    """Output texel centres of an oh × ow image in the pixel coordinates
    of an h × w one (in ``like``'s dtype and device), and half an output
    texel in input pixels."""
    ys = (torch.arange(oh, dtype=like.dtype, device=like.device) + 0.5) \
        * (h / oh) - 0.5
    xs = (torch.arange(ow, dtype=like.dtype, device=like.device) + 0.5) \
        * (w / ow) - 0.5
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    return yg, xg, 0.5 * (h / oh), 0.5 * (w / ow)


def _kawase_downsample(image):
    """Dual-kawase half-res downsample (Bloom.hlsl:81-95): centre tap × 4
    + four diagonal half-pixel taps, / 8."""
    h, w = image.shape[0], image.shape[1]
    yg, xg, hy, hx = _tap_grid(h, w, max(h // 2, 1), max(w // 2, 1), image)
    out = 4.0 * _bilinear_sample(image, yg, xg)
    for sy, sx in ((hy, hx), (hy, -hx), (-hy, hx), (-hy, -hx)):
        out = out + _bilinear_sample(image, yg + sy, xg + sx)
    return out / 8.0


def _kawase_upsample(image, oh, ow):
    """Dual-kawase upsample (Bloom.hlsl:98-117): 8 taps in a diamond, / 12."""
    yg, xg, hy, hx = _tap_grid(image.shape[0], image.shape[1], oh, ow, image)
    taps = [((0.0, -2.0 * hx), 1.0), ((hy, -hx), 2.0),
            ((2.0 * hy, 0.0), 1.0), ((hy, hx), 2.0),
            ((0.0, 2.0 * hx), 1.0), ((-hy, hx), 2.0),
            ((-2.0 * hy, 0.0), 1.0), ((-hy, -hx), 2.0)]
    out = torch.zeros((oh, ow, 3), dtype=image.dtype, device=image.device)
    for (sy, sx), wgt in taps:
        out = out + wgt * _bilinear_sample(image, yg + sy, xg + sx)
    return out / 12.0


def dual_kawase_bloom(image, threshold: float, half_passes: int = 3):
    """Dual-kawase bloom (CameraEffects.cpp DualKawaseBloom::filter +
    Bloom.hlsl:70-117): extract high intensity, ``half_passes`` 5-tap
    half-res downsamples, matching 8-tap upsamples, add back. An infinite
    threshold disables bloom (the default)."""
    if not np.isfinite(threshold) or half_passes <= 0:
        return image
    high = torch.clamp_min(image - threshold, 0.0)
    base = image - high
    levels = [tuple(high.shape[:2])]
    x = high
    for _ in range(half_passes):
        x = _kawase_downsample(x)
        levels.append(tuple(x.shape[:2]))
    for oh, ow in reversed(levels[:-1]):
        x = _kawase_upsample(x, oh, ow)
    return base + x
