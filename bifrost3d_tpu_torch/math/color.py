"""Color helpers on tensors with a trailing RGB axis.

Port of the slice's part of ``bifrost3d_tpu/math/color.py``
(``luminance``, ``srgb_to_linear``); the sRGB encode of PNG output is
numpy, in ``io/image``.
"""

from __future__ import annotations

import torch

# Rec.709 / sRGB luminance weights (Math/Color.h luminance()).
LUMA = (0.2126, 0.7152, 0.0722)


def luminance(rgb):
    w = torch.tensor(LUMA, dtype=torch.float32, device=rgb.device)
    return torch.sum(rgb[..., :3] * w, dim=-1)


def srgb_to_linear(c):
    """Exact sRGB EOTF (piecewise), matching Math/Color.h gammacorrect."""
    c = torch.as_tensor(c, dtype=torch.float32)
    low = c / 12.92
    high = ((c + 0.055) / 1.055) ** 2.4
    return torch.where(c <= 0.04045, low, high)
