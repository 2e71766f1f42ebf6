"""Color helpers on tensors with a trailing RGB axis.

Port of the slice's part of ``bifrost3d_tpu/math/color.py``
(``luminance``, ``srgb_to_linear``, ``linear_to_srgb``).
"""

from __future__ import annotations

import torch

# Rec.709 / sRGB luminance weights (Math/Color.h luminance()).
LUMA = (0.2126, 0.7152, 0.0722)


def luminance(rgb):
    w = torch.tensor(LUMA, dtype=torch.float32, device=rgb.device)
    return torch.sum(rgb[..., :3] * w, dim=-1)


def _float(c):
    """float32, except a float64 tensor, which stays float64 (the parity
    tests run the formulas in float64 too)."""
    if isinstance(c, torch.Tensor) and c.dtype == torch.float64:
        return c
    return torch.as_tensor(c, dtype=torch.float32)


def srgb_to_linear(c):
    """Exact sRGB EOTF (piecewise), matching Math/Color.h gammacorrect."""
    c = _float(c)
    low = c / 12.92
    high = ((c + 0.055) / 1.055) ** 2.4
    return torch.where(c <= 0.04045, low, high)


def linear_to_srgb(c):
    """The inverse of :func:`srgb_to_linear`; negative values encode as 0."""
    c = torch.clamp_min(_float(c), 0.0)
    low = c * 12.92
    high = 1.055 * c ** (1.0 / 2.4) - 0.055
    return torch.where(c <= 0.0031308, low, high)
