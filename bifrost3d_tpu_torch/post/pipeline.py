"""The camera-effects chain: exposure → bloom → vignette → tonemap → grain.

Port of ``bifrost3d_tpu/post/pipeline.py::process`` (its first-frame
behaviour: eye adaptation snaps to the target exposure). The stateful
variant with temporal eye adaptation and the dual-kawase bloom are not on
the slice.
"""

from __future__ import annotations

import torch

from bifrost3d_tpu_torch.post.bloom import gaussian_bloom
from bifrost3d_tpu_torch.post.exposure import (
    fixed_exposure,
    histogram_exposure,
    log_average_exposure,
)
from bifrost3d_tpu_torch.post.tonemap import (
    EXPOSURE_FIXED,
    EXPOSURE_HISTOGRAM,
    EXPOSURE_LOG_AVERAGE,
    CameraEffectsSettings,
    apply_tonemap,
)
from bifrost3d_tpu_torch.sampling.hashes import pcg2d, uint_to_unit_float


def process(image, settings: CameraEffectsSettings = CameraEffectsSettings.preset(),
            frame_index: int = 0):
    """HDR radiance [h, w, 3] → display-ready linear [0, 1]."""
    h, w = image.shape[0], image.shape[1]
    device = image.device

    if settings.exposure_mode == EXPOSURE_FIXED:
        exposure = fixed_exposure(settings.log_luminance_bias, device=device)
    elif settings.exposure_mode == EXPOSURE_LOG_AVERAGE:
        exposure = log_average_exposure(image, settings.log_luminance_bias)
    elif settings.exposure_mode == EXPOSURE_HISTOGRAM:
        exposure = histogram_exposure(
            image, settings.min_log_luminance, settings.max_log_luminance,
            settings.min_histogram_percentage,
            settings.max_histogram_percentage, settings.log_luminance_bias)
    else:
        raise ValueError(f"unknown exposure mode {settings.exposure_mode}")
    image = image * exposure

    if settings.bloom_mode == 1:
        raise NotImplementedError("dual-kawase bloom is not ported yet")
    image = gaussian_bloom(image, settings.bloom_threshold,
                           settings.bloom_support)

    if settings.vignette > 0.0:
        ys = (torch.arange(h, device=device) + 0.5) / h - 0.5
        xs = (torch.arange(w, device=device) + 0.5) / w - 0.5
        r2 = (xs[None, :] ** 2 + ys[:, None] ** 2) * 2.0
        falloff = 1.0 - settings.vignette * r2
        image = image * torch.clamp(falloff, 0.0, 1.0)[..., None]

    image = apply_tonemap(image, settings.tonemapping_mode,
                          settings.tonemapping)

    if settings.film_grain > 0.0:
        xi = torch.arange(w, dtype=torch.int64, device=device)[None, :]
        yi = torch.arange(h, dtype=torch.int64, device=device)[:, None]
        hashv, _ = pcg2d((xi * 9781 + frame_index) & 0xFFFFFFFF,
                         (yi * 6271 + frame_index * 31) & 0xFFFFFFFF)
        noise = uint_to_unit_float(hashv) - 0.5
        image = image + (2.0 * settings.film_grain) * noise[..., None]

    return torch.clamp(image, 0.0, 1.0)
