"""Prefiltered image-based lighting (GGX-convolved environment mips).

Port of ``bifrost3d_tpu/preview/ibl.py`` (``_downsample2``,
``convolve_environment``, ``_convolve_level``, ``sample_ibl``), the
counterpart of the DX11 EnvironmentManager's convolved IBL mip chain
(EnvironmentManager.cpp:36,110-125 + IBLConvolution.hlsl) and of the
EnvironmentConvolution app: each level halves the latlong map (to a
16-pixel floor) and convolves it with the GGX lobe of its roughness,
importance-sampled through the VNDF at PMJ02 points (split sum: wo along
the normal); shading fetches the level of the surface's roughness and
blends the two around it. JAX's ``lax.scan`` over the samples is a loop
here, which keeps its order of summation.
"""

from __future__ import annotations

import numpy as np
import torch

from bifrost3d_tpu_torch.lights.environment import (
    direction_to_latlong_uv,
    latlong_uv_to_direction,
)
from bifrost3d_tpu_torch.math.clip import maximum
from bifrost3d_tpu_torch.math.vec import normalize, orthonormal_basis, reflect
from bifrost3d_tpu_torch.sampling.distributions import ggx_vndf_sample_halfway
from bifrost3d_tpu_torch.sampling.pmj import pmj02_bn_samples

MIN_MIP_SIZE = 16


def _downsample2(img):
    h, w = img.shape[0] // 2, img.shape[1] // 2
    return 0.25 * (img[0::2, 0::2][:h, :w] + img[1::2, 0::2][:h, :w]
                   + img[0::2, 1::2][:h, :w] + img[1::2, 1::2][:h, :w])


def convolve_environment(environment, roughness_levels=None,
                         samples: int = 64):
    """→ list of (roughness, latlong image [h, w, 3]) GGX-prefiltered mips.

    Level 0 is the unfiltered map (``environment``, a tensor on the device
    to convolve on); each later level halves the resolution (to a 16-pixel
    floor, EnvironmentManager.cpp:110-125) and convolves with the GGX lobe
    of its roughness. ``roughness_levels[0]`` is taken as 0.
    """
    env = environment.to(torch.float32)
    if roughness_levels is None:
        n_levels = max(2, int(np.log2(env.shape[0] / MIN_MIP_SIZE)) + 1)
        roughness_levels = [i / (n_levels - 1) for i in range(n_levels)]
    u2 = torch.tensor(pmj02_bn_samples(samples), device=env.device)
    mips = [(0.0, env)]
    current = env
    for roughness in roughness_levels[1:]:
        if current.shape[0] > MIN_MIP_SIZE:
            current = _downsample2(current)
        mips.append((float(roughness),
                     _convolve_level(current, float(roughness), u2)))
    return mips


def _convolve_level(env, roughness, u2):
    """One level: for every texel's direction (the normal, with wo along
    it), the GGX-weighted average of the map over ``u2``'s [s, 2] samples,
    each weighted by its reflected direction's cosine."""
    h, w = env.shape[0], env.shape[1]
    dtype, device = env.dtype, env.device
    us = (torch.arange(w, dtype=dtype, device=device) + 0.5) / w
    vs = (torch.arange(h, dtype=dtype, device=device) + 0.5) / h
    uu, vv = torch.meshgrid(us, vs, indexing="xy")
    normal = latlong_uv_to_direction(torch.stack([uu, vv], -1))   # [h, w, 3]
    t, b = orthonormal_basis(normal)
    rough = torch.as_tensor(roughness, dtype=dtype, device=device)
    alpha = maximum(rough * rough, 1e-3)

    # The lobe about the normal is the same in every texel's frame: one
    # local direction per sample.
    u2 = u2.to(dtype)
    wo_local = torch.tensor([0.0, 0.0, 1.0], dtype=dtype,
                            device=device).expand(u2.shape[0], 3)
    half_local = ggx_vndf_sample_halfway(alpha, wo_local, u2)
    wi_local = reflect(-wo_local, half_local)                      # [s, 3]
    weights = maximum(wi_local[:, 2], 0.0)

    acc = torch.zeros_like(env)
    wsum = torch.zeros((), dtype=dtype, device=device)
    for s in range(u2.shape[0]):
        wl = wi_local[s]
        wi = normalize(wl[0:1] * t + wl[1:2] * b + wl[2:3] * normal)
        uv = direction_to_latlong_uv(wi)
        xi = torch.clamp((uv[..., 0] * w).to(torch.int64), 0, w - 1)
        yi = torch.clamp((uv[..., 1] * h).to(torch.int64), 0, h - 1)
        acc = acc + env[yi, xi] * weights[s]
        wsum = wsum + weights[s]
    return acc / maximum(wsum, 1e-6)


def _interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` for increasing ``xp`` (1-D tensors):
    piecewise linear, constant beyond the ends."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    epsilon = float(np.spacing(np.finfo(
        torch.empty((), dtype=xp.dtype).numpy().dtype).eps))
    dx0 = torch.abs(dx) <= epsilon
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def sample_ibl(mips, direction, roughness):
    """The prefiltered radiance along ``direction`` [..., 3] at
    ``roughness`` [...], blended between the two levels around it
    (DefaultShading.hlsl evaluate_IBL)."""
    uv = direction_to_latlong_uv(direction)
    dtype, device = direction.dtype, direction.device
    xp = torch.as_tensor(np.asarray([r for r, _ in mips], np.float32),
                         device=device).to(dtype)
    fp = torch.arange(len(mips), dtype=dtype, device=device)
    level = _interp(roughness.to(dtype), xp, fp)
    lo = torch.clamp(torch.floor(level).to(torch.int64), 0, len(mips) - 1)
    frac = level - lo.to(dtype)
    hi = torch.clamp(lo + 1, 0, len(mips) - 1)

    def fetch(img):
        h, w = img.shape[0], img.shape[1]
        xi = torch.clamp((uv[..., 0] * w).to(torch.int64), 0, w - 1)
        yi = torch.clamp((uv[..., 1] * h).to(torch.int64), 0, h - 1)
        return img.to(dtype)[yi, xi]

    out_lo = torch.zeros(direction.shape[:-1] + (3,), dtype=dtype,
                         device=device)
    out_hi = torch.zeros_like(out_lo)
    for i, (_, img) in enumerate(mips):
        f = fetch(img)
        out_lo = torch.where((lo == i)[..., None], f, out_lo)
        out_hi = torch.where((hi == i)[..., None], f, out_hi)
    return out_lo * (1.0 - frac[..., None]) + out_hi * frac[..., None]
