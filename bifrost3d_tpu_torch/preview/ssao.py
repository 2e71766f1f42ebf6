"""Screen-space ambient occlusion (Alchemy AO) with a bilateral blur.

Port of ``bifrost3d_tpu/preview/ssao.py`` (``ssao``, ``bilateral_blur``),
the counterpart of the DX11 SSAO pass (``DX11Renderer/SSAO.*``): Alchemy
AO over the G-buffer's view positions and normals with a per-pixel sample
rotation (``pcg2d``, bit for bit the JAX package's) and a depth-aware
cross blur whose taps wrap around the image, as ``jnp.roll``'s do.

A tap's pixel offset is ``round(cos(angle) · r)`` (half to even, as
``jnp.round``): where the float32 ``cos`` or ``sin`` of torch and of XLA
differ by an ulp, a tap that lies on a .5 boundary moves by one pixel.
"""

from __future__ import annotations

import math

import torch

from bifrost3d_tpu_torch.math.clip import clip, maximum
from bifrost3d_tpu_torch.sampling.hashes import UINT_NORMALIZER, pcg2d


def ssao(view_position, view_normal, valid_mask, world_radius: float = 0.25,
         bias: float = 0.01, intensity: float = 1.0, sample_count: int = 8):
    """→ occlusion [h, w] in [0 (occluded), 1 (open)].

    Alchemy AO: per pixel, sample nearby screen points, re-read their view
    positions, and accumulate max(0, dot(v, n) - bias·z) / (|v|² + eps).
    """
    h, w = view_position.shape[0], view_position.shape[1]
    device = view_position.device
    xi = torch.arange(w, dtype=torch.int64, device=device)[None, :].expand(h, w)
    yi = torch.arange(h, dtype=torch.int64, device=device)[:, None].expand(h, w)
    rot_hash, _ = pcg2d(xi, yi)
    # uint_to_unit_float in the positions' dtype.
    rot = rot_hash.to(view_position.dtype) * UINT_NORMALIZER * 2.0 * math.pi

    depth = view_position[..., 2]
    # Screen-space radius ∝ world radius / depth (projective scaling).
    radius_px = world_radius / maximum(depth, 0.1) * (h * 0.5)
    radius_px = clip(radius_px, 2.0, h * 0.25)

    occlusion = torch.zeros((h, w), dtype=view_position.dtype, device=device)
    for s in range(sample_count):
        angle = rot + s * (2.0 * math.pi / sample_count)
        r = maximum(radius_px * ((s + 0.5) / sample_count) ** 0.75, 1.0)
        dx = torch.round(torch.cos(angle) * r).to(torch.int64)
        dy = torch.round(torch.sin(angle) * r).to(torch.int64)
        sx = torch.clamp(xi + dx, 0, w - 1)
        sy = torch.clamp(yi + dy, 0, h - 1)
        v = view_position[sy, sx] - view_position
        vn = torch.sum(v * view_normal, dim=-1)
        vv = torch.sum(v * v, dim=-1)
        contrib = maximum(vn - bias * depth, 0.0) / (vv + 1e-4)
        sample_valid = valid_mask[sy, sx] & valid_mask
        occlusion = occlusion + torch.where(sample_valid, contrib, 0.0)

    ao = maximum(1.0 - 2.0 * intensity / sample_count * occlusion, 0.0)
    return torch.where(valid_mask, ao, 1.0)


def bilateral_blur(ao, depth, support: int = 4, depth_sigma: float = 0.1):
    """Depth-aware cross blur (the reference's bilateral box/cross
    filter)."""
    acc = torch.zeros_like(ao)
    wsum = torch.zeros_like(ao)
    for axis in (0, 1):
        for offset in range(-support, support + 1):
            shifted_ao = torch.roll(ao, offset, dims=axis)
            shifted_depth = torch.roll(depth, offset, dims=axis)
            w = torch.exp(-torch.square(shifted_depth - depth)
                          / (2.0 * depth_sigma * depth_sigma))
            acc = acc + shifted_ao * w
            wsum = wsum + w
    return acc / maximum(wsum, 1e-6)
