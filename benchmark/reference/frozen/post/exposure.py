"""Exposure estimation: fixed bias, log-average and 64-bin histogram.

Port of ``bifrost3d_tpu/post/exposure.py`` (``fixed_exposure``,
``eye_adaptation``, ``log_average_exposure``, ``luminance_histogram``,
``histogram_exposure``). Each returns a linear exposure multiplier as a
0-d tensor.
"""

from __future__ import annotations

import torch

from benchmark.reference.frozen.math.color import luminance

HISTOGRAM_BINS = 64


def fixed_exposure(log_luminance_bias=0.0, *, device):
    return torch.exp2(torch.tensor(log_luminance_bias, dtype=torch.float32,
                                   device=device))


def eye_adaptation(current_exposure, target_exposure, delta_time,
                   brightness_speed=3.0, darkness_speed=1.0):
    """Temporal eye adaptation (Shaders/CameraEffects/Utils.hlsl:45-50):
    lerp the exposure toward the target with an exponential rate that
    differs for brightening and darkening (CameraEffects.h:71-73 defaults
    3.0 / 1.0). Tensors of any matching shape; ``delta_time`` a number or
    a tensor."""
    delta_exposure = target_exposure - current_exposure
    speed = torch.where(delta_exposure > 0.0, brightness_speed,
                        darkness_speed)
    delta_time = torch.as_tensor(delta_time, dtype=delta_exposure.dtype,
                                 device=delta_exposure.device)
    factor = 1.0 - torch.exp2(-delta_time * speed)
    return current_exposure + delta_exposure * factor


def _linear_exposure_from_average(average_luminance, log_luminance_bias):
    key = 1.03 - 2.0 / (2.0 + torch.log10(average_luminance + 1.0))
    return (key / torch.clamp_min(average_luminance, 1e-6)
            * 2.0 ** log_luminance_bias)


def log_average_exposure(image, log_luminance_bias=0.0):
    """exp(mean(log(lum))) based exposure."""
    lum = luminance(image)
    log_avg = torch.exp(torch.mean(torch.log(torch.clamp_min(lum, 1e-6))))
    return _linear_exposure_from_average(log_avg, log_luminance_bias)


def luminance_histogram(image, min_log_luminance=-4.0, max_log_luminance=4.0,
                        bins=HISTOGRAM_BINS):
    """64-bin log2-luminance histogram (int32 counts)."""
    lum = luminance(image)
    log_lum = torch.log2(torch.clamp_min(lum, 1e-10))
    t = (log_lum - min_log_luminance) / (max_log_luminance - min_log_luminance)
    idx = torch.clamp((t * bins).to(torch.int64), 0, bins - 1).reshape(-1)
    hist = torch.zeros(bins, dtype=torch.int32, device=image.device)
    return hist.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))


def histogram_exposure(image, min_log_luminance=-4.0, max_log_luminance=4.0,
                       min_percentage=0.7, max_percentage=0.95,
                       log_luminance_bias=0.0, bins=HISTOGRAM_BINS):
    """Average luminance between the [min, max] percentiles of the
    histogram, rejecting outliers; exposure = exp2(bias) / average."""
    hist = luminance_histogram(image, min_log_luminance, max_log_luminance,
                               bins).to(torch.float32)
    total = torch.sum(hist)
    lo = total * min_percentage
    hi = total * max_percentage
    cum_before = torch.cat([torch.zeros(1, device=image.device),
                            torch.cumsum(hist, dim=0)[:-1]])
    cum_after = cum_before + hist
    contribution = (torch.clamp(hi.expand(bins), cum_before, cum_after)
                    - torch.clamp(lo.expand(bins), cum_before, cum_after))
    centers = (torch.arange(bins, device=image.device) + 0.5) / bins
    bin_lum = torch.exp2(min_log_luminance
                         + centers * (max_log_luminance - min_log_luminance))
    avg = (torch.sum(contribution * bin_lum)
           / torch.clamp_min(torch.sum(contribution), 1e-6))
    return 2.0 ** log_luminance_bias / torch.clamp_min(avg, 1e-6)
