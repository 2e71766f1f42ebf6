"""Color helpers on tensors with a trailing RGB axis.

Port of ``bifrost3d_tpu/math/color.py`` (``luminance``,
``srgb_to_linear``, ``linear_to_srgb``, ``rgb_to_hsv``, ``hsv_to_rgb``).
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


def rgb_to_hsv(rgb):
    """RGB → HSV with H in [0, 360). Vectorized over leading axes."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = torch.amax(rgb, dim=-1)
    c_min = torch.amin(rgb, dim=-1)
    delta = v - c_min
    safe = torch.where(delta > 0, delta, 1.0)
    h_r = torch.remainder((g - b) / safe, 6.0)
    h_g = (b - r) / safe + 2.0
    h_b = (r - g) / safe + 4.0
    h = torch.where(v == r, h_r, torch.where(v == g, h_g, h_b)) * 60.0
    h = torch.where(delta > 0, h, 0.0)
    s = torch.where(v > 0, delta / torch.where(v > 0, v, 1.0), 0.0)
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    c = v * s
    hp = h / 60.0
    x = c * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    z = torch.zeros_like(c)
    i = torch.floor(hp).to(torch.int32) % 6

    def select(*values):
        """``values[k]`` where ``i == k`` (jnp.select over the six
        sextants, 0 outside them)."""
        out = z
        for k in range(5, -1, -1):
            out = torch.where(i == k, values[k], out)
        return out

    m = v - c
    return torch.stack([select(c, x, z, z, x, c) + m,
                        select(x, c, c, x, z, z) + m,
                        select(z, z, x, c, c, x) + m], dim=-1)
