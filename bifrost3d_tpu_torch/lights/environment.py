"""Environment (infinite-area) light: CDF importance sampling + presampling.

Port of ``bifrost3d_tpu/lights/environment.py`` (all of it), the
counterpart of ``Assets/InfiniteAreaLight`` and the renderer's
``EnvironmentMap`` / ``PresampledEnvironmentMap``:

- Per-pixel importance = (r + g + b) · sin(θ) (InfiniteAreaLight.cpp:38-58).
- Height is resampled up to ``MINIMUM_PDF_HEIGHT = 128`` rows so small maps
  still sample well.
- With bilinear filtering the importance is blurred 3x3 with weights
  20/2/1 over 32 so black texels bordering bright ones keep nonzero PDF
  (InfiniteAreaLight.cpp:66-121).
- ``per_pixel_pdf`` is reconstructed from CDF differences scaled by
  w·h/(2π²): the solid-angle PDF without its 1/sin(θ) factor
  (InfiniteAreaLight.cpp:140-157); sampling divides by sin(θ).
- The presampled variant draws a power-of-two pool of samples once per
  scene change with PMJ-BN randoms in bit-reversed order; the per-bounce
  lookup is an index (PresampledEnvironmentMap.cpp:19-101).

Lat-long mapping (Utils.h:288-301):
``direction = -(sinθ·cosφ, cosθ, sinθ·sinφ)`` with φ = 2πu, θ = πv.

The tables are built on the host (numpy and CPU tensors, as the JAX package
builds them with numpy) and moved to the scene's device once.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bifrost3d_tpu_torch.lights.types import LightSample
from bifrost3d_tpu_torch.math.clip import clip, maximum
from bifrost3d_tpu_torch.math.distribution2d import Distribution2D
from bifrost3d_tpu_torch.sampling.hashes import reverse_bits
from bifrost3d_tpu_torch.sampling.pmj import pmj02_bn_samples

MINIMUM_PDF_HEIGHT = 128
PI = float(np.float32(np.pi))
# float32 constants, rounded as the JAX package's numpy scalars are.
_HALF_OVER_PI = float(np.float32(0.5) / np.float32(np.pi))
_HALF_PI = float(np.float32(np.pi) * np.float32(0.5))
_TWO_PI = float(np.float32(2.0) * np.float32(np.pi))


def direction_to_latlong_uv(direction):
    u = (torch.atan2(direction[..., 2], direction[..., 0]) + PI) * _HALF_OVER_PI
    v = (torch.asin(clip(direction[..., 1], -1.0, 1.0)) + _HALF_PI) / PI
    return torch.stack([u, v], dim=-1)


def latlong_uv_to_direction(uv):
    phi = uv[..., 0] * _TWO_PI
    theta = uv[..., 1] * PI
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    return -torch.stack([sin_t * torch.cos(phi), cos_t, sin_t * torch.sin(phi)],
                        dim=-1)


class EnvironmentLight(NamedTuple):
    image: torch.Tensor          # [h, w, 3] radiance map
    tint: torch.Tensor           # [3]
    distribution: Distribution2D  # over the (possibly resampled) PDF grid
    per_pixel_pdf: torch.Tensor  # [ph, pw] solid-angle pdf without 1/sinθ

    @property
    def pdf_size(self):
        return tuple(self.per_pixel_pdf.shape)

    def to(self, device) -> "EnvironmentLight":
        return EnvironmentLight(
            self.image.to(device), self.tint.to(device),
            self.distribution.to(device), self.per_pixel_pdf.to(device))

    @staticmethod
    def from_numpy(arrays: dict, *, device) -> "EnvironmentLight":
        """From a dict of this type's field arrays (``distribution`` a dict
        of ``Distribution2D``'s)."""
        def t(a):
            return torch.tensor(np.asarray(a, np.float32), device=device)
        dist = arrays["distribution"]
        return EnvironmentLight(
            image=t(arrays["image"]), tint=t(arrays["tint"]),
            distribution=Distribution2D(
                marginal_cdf=t(dist["marginal_cdf"]),
                conditional_cdf=t(dist["conditional_cdf"]),
                integral=t(dist["integral"])),
            per_pixel_pdf=t(arrays["per_pixel_pdf"]))


def _bilinear_sample(image, uv):
    """Bilinear lookup with wrap-u / clamp-v (latlong semantics)."""
    h, w = image.shape[0], image.shape[1]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    x0w = torch.remainder(x0, w)
    x1w = torch.remainder(x0 + 1, w)
    y0c = torch.clamp(y0, 0, h - 1)
    y1c = torch.clamp(y0 + 1, 0, h - 1)
    p00 = image[y0c, x0w]
    p10 = image[y0c, x1w]
    p01 = image[y1c, x0w]
    p11 = image[y1c, x1w]
    return ((p00 * (1 - fx) + p10 * fx) * (1 - fy)
            + (p01 * (1 - fx) + p11 * fx) * fy)


def build_environment_light(image, tint=(1.0, 1.0, 1.0),
                            bilinear_filtering: bool = True, *,
                            device) -> EnvironmentLight:
    """Build the importance-sampling tables from a latlong radiance map
    [h, w, 3] (numpy) → the light on ``device``."""
    img = np.asarray(image, np.float32)
    h, w = img.shape[0], img.shape[1]
    ph = max(h, MINIMUM_PDF_HEIGHT)
    resample = ph != h
    pw = w

    if resample:
        # Point-sample the image at the PDF resolution (bilinear).
        vs = (np.arange(ph) + 0.5) / ph
        us = (np.arange(pw) + 0.5) / pw
        uu, vv = np.meshgrid(us, vs)
        uv = torch.tensor(np.stack([uu, vv], -1), dtype=torch.float32)
        pixels = _bilinear_sample(torch.tensor(img), uv).numpy()
    else:
        pixels = img

    sin_theta = np.sin(np.pi * (np.arange(ph) + 0.5) / ph)[:, None]
    importance = pixels.sum(axis=-1) * sin_theta

    if bilinear_filtering or resample:
        # 3x3 blur, weights 20 center / 2 sides / 1 corners over 32;
        # wrap in x (repeat), clamp in y (InfiniteAreaLight.cpp:66-121).
        p = importance
        left = np.roll(p, 1, axis=1)
        right = np.roll(p, -1, axis=1)
        up = np.concatenate([p[:1], p[:-1]], axis=0)
        down = np.concatenate([p[1:], p[-1:]], axis=0)
        ul = np.concatenate([left[:1], left[:-1]], axis=0)
        dl = np.concatenate([left[1:], left[-1:]], axis=0)
        ur = np.concatenate([right[:1], right[:-1]], axis=0)
        dr = np.concatenate([right[1:], right[-1:]], axis=0)
        importance = (20 * p + 2 * (left + right + up + down)
                      + (ul + dl + ur + dr)) / 32.0

    dist = Distribution2D.build(torch.tensor(importance, dtype=torch.float32))

    # Per-pixel solid-angle PDF without sinθ, from CDF differences.
    marginal_pdf = dist.marginal_cdf[1:] - dist.marginal_cdf[:-1]       # [ph]
    conditional_pdf = dist.conditional_cdf[:, 1:] - dist.conditional_cdf[:, :-1]
    pdf_scale = (pw * ph) / (2.0 * np.pi * np.pi)
    per_pixel_pdf = marginal_pdf[:, None] * conditional_pdf * pdf_scale

    return EnvironmentLight(
        image=torch.tensor(img),
        tint=torch.tensor(tint, dtype=torch.float32),
        distribution=dist,
        per_pixel_pdf=per_pixel_pdf).to(device)


def _pdf_at(light: EnvironmentLight, uv, direction):
    """Per-pixel pdf of the cell holding ``uv``, over sinθ."""
    sin_theta = torch.sqrt(maximum(1.0 - direction[..., 1] ** 2, 0.0))
    ph, pw = light.pdf_size
    xi = torch.clamp((uv[..., 0] * pw).to(torch.int64), 0, pw - 1)
    yi = torch.clamp((uv[..., 1] * ph).to(torch.int64), 0, ph - 1)
    pdf = light.per_pixel_pdf[yi, xi] / maximum(sin_theta, 1e-10)
    return torch.where(sin_theta == 0.0, 0.0, pdf)


def environment_sample(light: EnvironmentLight, u2) -> LightSample:
    """CDF-search sample (EnvironmentLightImpl.h:22-83)."""
    uv, _ = light.distribution.sample_continuous(u2)
    direction = latlong_uv_to_direction(uv)
    radiance = _bilinear_sample(light.image, uv) * light.tint
    pdf = _pdf_at(light, uv, direction)
    return LightSample(
        direction=direction,
        distance=torch.full_like(pdf, 1e30),
        radiance=radiance,
        pdf=pdf,
        is_delta=torch.zeros_like(pdf, dtype=torch.bool))


def environment_pdf(light: EnvironmentLight, direction):
    return _pdf_at(light, direction_to_latlong_uv(direction), direction)


def environment_evaluate(light: EnvironmentLight, direction):
    """Radiance of the environment along a (miss) direction."""
    uv = direction_to_latlong_uv(direction)
    return _bilinear_sample(light.image, uv) * light.tint


# -- presampled environment (the reference's default, Defines.h:15) ----------

class PresampledEnvironmentLight(NamedTuple):
    light: EnvironmentLight
    directions: torch.Tensor  # [n, 3]
    radiances: torch.Tensor   # [n, 3], the light's tint included
    pdfs: torch.Tensor        # [n]

    @property
    def sample_count(self) -> int:
        return int(self.pdfs.shape[0])

    @property
    def nee_enabled(self) -> bool:
        """A pool of one sample means the map had no usable importance
        (PresampledEnvironmentMap.h:64)."""
        return self.sample_count > 1


def presample_environment(light: EnvironmentLight, sample_count: int = 8192,
                          blue_noise_candidates: int = 8
                          ) -> PresampledEnvironmentLight:
    """Draw the sample pool with PMJ-BN randoms in bit-reversed order, for
    stratification coherence (PresampledEnvironmentMap.cpp:62-88), on the
    light's device."""
    if sample_count < 1 or sample_count & (sample_count - 1):
        raise ValueError("the pool's size must be a power of two")
    u2 = pmj02_bn_samples(sample_count, blue_noise_candidates)
    order = reverse_bits(torch.arange(sample_count, dtype=torch.int64))
    order = order >> (32 - sample_count.bit_length() + 1)
    u2 = u2[torch.argsort(order, stable=True).numpy()]
    s = environment_sample(light, torch.tensor(u2, device=light.image.device))
    return PresampledEnvironmentLight(
        light=light, directions=s.direction, radiances=s.radiance, pdfs=s.pdf)


def presampled_environment_sample(pool: PresampledEnvironmentLight,
                                  u) -> LightSample:
    """Index the pool with a uniform random u [...]."""
    n = pool.sample_count
    idx = torch.clamp((u * n).to(torch.int64), 0, n - 1)
    pdf = pool.pdfs[idx]
    return LightSample(
        direction=pool.directions[idx],
        distance=torch.full_like(pdf, 1e30),
        radiance=pool.radiances[idx],
        pdf=pdf,
        is_delta=torch.zeros_like(pdf, dtype=torch.bool))
