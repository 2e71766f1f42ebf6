"""The camera-effects chain: exposure → bloom → vignette → tonemap → grain.

Port of ``bifrost3d_tpu/post/pipeline.py`` (``process``,
``process_stateful``): exposure (fixed, log-average or histogram, with
temporal eye adaptation in the stateful variant), Gaussian or dual-kawase
bloom, vignette, tonemapping and film grain.

An image on a CUDA card goes through the two kernels of
``post/post_chain.py`` (``csrc/post_chain.cu``), which take every setting
as an argument and so copy nothing to the card and wait for nothing; any
other image through the eager chain, :func:`_process_plain`, their plain
version.
"""

from __future__ import annotations

import numpy as np
import torch

from bifrost3d_tpu_torch.post import post_chain
from bifrost3d_tpu_torch.post.bloom import dual_kawase_bloom, gaussian_bloom
from bifrost3d_tpu_torch.post.exposure import (
    eye_adaptation,
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
from bifrost3d_tpu_torch.utils.profiling import span


def process(image, settings: CameraEffectsSettings = CameraEffectsSettings.preset(),
            frame_index: int = 0):
    """HDR radiance [h, w, 3] → display-ready linear [0, 1]."""
    ldr, _ = _process(image, settings, frame_index, -1.0, 0.0)
    return ldr


def process_stateful(image, settings: CameraEffectsSettings,
                     frame_index: int, previous_exposure, delta_time):
    """Like :func:`process` but with temporal eye adaptation
    (CameraEffects.cpp:456-469 + Utils.hlsl eye_adaptation): the exposure
    lerps from ``previous_exposure`` toward the frame's target at the
    settings' brightness/darkness speeds. Pass ``previous_exposure < 0``
    on the first frame (adaptation snaps to the target). Returns
    (ldr_image, applied_exposure), the exposure a 0-d tensor to feed back
    next frame."""
    return _process(image, settings, frame_index, previous_exposure,
                    delta_time)


def _process(image, settings: CameraEffectsSettings, frame_index: int,
             previous_exposure, delta_time):
    """The chain, chosen by the image's device: on a CUDA card the two
    kernels of ``post/post_chain.py`` (no host copy, no wait; bloom, where
    it runs, eager between them), elsewhere :func:`_process_plain`."""
    if image.device.type == "cuda":
        return _process_cuda(image, settings, frame_index, previous_exposure,
                             delta_time)
    return _process_plain(image, settings, frame_index, previous_exposure,
                          delta_time)


def _bloom(image, settings: CameraEffectsSettings):
    """The settings' bloom of ``image`` (itself where bloom is off)."""
    if settings.bloom_mode == 1:
        h = image.shape[0]
        half_passes = max(1, int(round(
            settings.bloom_support * h / 128.0))) \
            if settings.bloom_support > 0 else 0
        return dual_kawase_bloom(image, settings.bloom_threshold, half_passes)
    return gaussian_bloom(image, settings.bloom_threshold,
                          settings.bloom_support)


def _process_cuda(image, settings: CameraEffectsSettings, frame_index: int,
                  previous_exposure, delta_time):
    """The chain on the card; under a ``torch.profiler`` session span
    ``b3d.post.process`` holds ``b3d.post.exposure`` (the exposure kernel),
    ``.bloom`` where bloom runs, and ``.tonemap`` (the apply kernel)."""
    with span("post.process"):
        with span("post.exposure"):
            exposure = post_chain.exposure_cuda(image, settings,
                                                previous_exposure, delta_time)
        scale = exposure
        # gaussian_bloom and dual_kawase_bloom return their input unless
        # the threshold is finite and the support positive.
        if np.isfinite(settings.bloom_threshold) and settings.bloom_support > 0:
            with span("post.bloom"):
                image = _bloom(image * exposure, settings)
            scale = 1.0
        with span("post.tonemap"):
            ldr = post_chain.apply_cuda(image, scale, settings, frame_index)
        return ldr, exposure


def _process_plain(image, settings: CameraEffectsSettings, frame_index: int,
                   previous_exposure, delta_time):
    """The eager chain, on any device (the kernels' plain version); under a
    ``torch.profiler`` session it is span ``b3d.post.process``, with one
    span per stage that runs: ``b3d.post.exposure`` (eye adaptation
    included), ``.bloom``, ``.vignette``, ``.tonemap`` and ``.grain``."""
    with span("post.process"):
        h, w = image.shape[0], image.shape[1]
        device = image.device

        with span("post.exposure"):
            if settings.exposure_mode == EXPOSURE_FIXED:
                exposure = fixed_exposure(settings.log_luminance_bias,
                                          device=device)
            elif settings.exposure_mode == EXPOSURE_LOG_AVERAGE:
                exposure = log_average_exposure(image,
                                                settings.log_luminance_bias)
            elif settings.exposure_mode == EXPOSURE_HISTOGRAM:
                exposure = histogram_exposure(
                    image, settings.min_log_luminance,
                    settings.max_log_luminance,
                    settings.min_histogram_percentage,
                    settings.max_histogram_percentage,
                    settings.log_luminance_bias)
            else:
                raise ValueError(
                    f"unknown exposure mode {settings.exposure_mode}")
            if settings.eye_adaptation_enabled:
                previous = torch.as_tensor(previous_exposure,
                                           dtype=torch.float32, device=device)
                adapted = eye_adaptation(previous, exposure, delta_time,
                                         settings.eye_adaptation_brightness,
                                         settings.eye_adaptation_darkness)
                # previous < 0 = no history (first frame): snap to the
                # target.
                exposure = torch.where(previous >= 0.0, adapted, exposure)
            image = image * exposure

        with span("post.bloom"):
            image = _bloom(image, settings)

        if settings.vignette > 0.0:
            with span("post.vignette"):
                ys = (torch.arange(h, device=device) + 0.5) / h - 0.5
                xs = (torch.arange(w, device=device) + 0.5) / w - 0.5
                r2 = (xs[None, :] ** 2 + ys[:, None] ** 2) * 2.0
                falloff = 1.0 - settings.vignette * r2
                image = image * torch.clamp(falloff, 0.0, 1.0)[..., None]

        with span("post.tonemap"):
            image = apply_tonemap(image, settings.tonemapping_mode,
                                  settings.tonemapping)

        if settings.film_grain > 0.0:
            with span("post.grain"):
                xi = torch.arange(w, dtype=torch.int64, device=device)[None, :]
                yi = torch.arange(h, dtype=torch.int64, device=device)[:, None]
                hashv, _ = pcg2d((xi * 9781 + frame_index) & 0xFFFFFFFF,
                                 (yi * 6271 + frame_index * 31) & 0xFFFFFFFF)
                noise = uint_to_unit_float(hashv) - 0.5
                image = image + (2.0 * settings.film_grain) * noise[..., None]

        return torch.clamp(image, 0.0, 1.0), exposure
