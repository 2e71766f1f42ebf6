"""Tonemapping operators and the camera-effects settings.

Port of ``bifrost3d_tpu/post/tonemap.py`` (``TonemappingSettings``,
``CameraEffectsSettings``, ``reinhard``, ``filmic``, ``agx``,
``khronos_neutral``, ``apply_tonemap``): linear sRGB radiance [..., 3] →
displayable linear sRGB in [0, 1].
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bifrost3d_tpu_torch.math.clip import maximum
from bifrost3d_tpu_torch.math.color import luminance
from bifrost3d_tpu_torch.math.vec import lerp

TONEMAP_LINEAR = 0
TONEMAP_FILMIC = 1
TONEMAP_AGX = 2
TONEMAP_KHRONOS_NEUTRAL = 3

EXPOSURE_FIXED = 0
EXPOSURE_LOG_AVERAGE = 1
EXPOSURE_HISTOGRAM = 2


class TonemappingSettings(NamedTuple):
    black_clip: float = 0.0
    toe: float = 0.53
    slope: float = 0.91
    shoulder: float = 0.23
    white_clip: float = 0.035

    @staticmethod
    def aces():
        return TonemappingSettings(0.0, 0.53, 0.91, 0.23, 0.035)


class CameraEffectsSettings(NamedTuple):
    """Counterpart of CameraEffects::Settings (CameraEffects.h:35-113)."""

    exposure_mode: int = EXPOSURE_HISTOGRAM
    min_log_luminance: float = -4.0
    max_log_luminance: float = 4.0
    min_histogram_percentage: float = 0.7
    max_histogram_percentage: float = 0.95
    log_luminance_bias: float = 0.0
    bloom_threshold: float = np.inf
    bloom_support: float = 0.05
    vignette: float = 0.63
    tonemapping_mode: int = TONEMAP_FILMIC
    tonemapping: TonemappingSettings = TonemappingSettings.aces()
    film_grain: float = 1.0 / 255.0
    # Bloom variant: gaussian (the default) or dual-kawase, which reads
    # bloom_support·height/128 as its number of half-res passes.
    bloom_mode: int = 0          # 0 = gaussian, 1 = dual-kawase
    # Temporal eye adaptation (CameraEffects.h:71-73 defaults): the
    # stateful post path (post.pipeline.process_stateful) lerps the
    # exposure toward the target at these per-second exp2 rates.
    eye_adaptation_enabled: bool = True
    eye_adaptation_brightness: float = 3.0
    eye_adaptation_darkness: float = 1.0

    @staticmethod
    def preset() -> "CameraEffectsSettings":
        return CameraEffectsSettings()

    @staticmethod
    def linear() -> "CameraEffectsSettings":
        return CameraEffectsSettings(
            exposure_mode=EXPOSURE_FIXED, bloom_support=0.0, vignette=0.0,
            tonemapping_mode=TONEMAP_LINEAR, film_grain=0.0)


def reinhard(color, white_level_sqrd=1.0):
    lum = luminance(color)[..., None]
    tonemapped = lum * (1.0 + lum / white_level_sqrd) / (1.0 + lum)
    return color * tonemapped / maximum(lum, 1e-10)


def _mat(m: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(m, np.float32), device=like.device)


# -- UE4 filmic / ACES ----------------------------------------------------------

_D65_TO_D60 = np.asarray([
    [1.01303, 0.00610531, -0.014971],
    [0.00769823, 0.998165, -0.00503203],
    [-0.00284131, 0.00468516, 0.924507]])
_SRGB_TO_XYZ = np.asarray([
    [0.4124564, 0.3575761, 0.1804375],
    [0.2126729, 0.7151522, 0.0721750],
    [0.0193339, 0.1191920, 0.9503041]])
_XYZ_TO_AP1 = np.asarray([
    [1.6410233797, -0.3248032942, -0.2364246952],
    [-0.6636628587, 1.6153315917, 0.0167563477],
    [0.0117218943, -0.0082844420, 0.9883948585]])
_AP1_TO_XYZ = np.asarray([
    [0.6624541811, 0.1340042065, 0.1561876870],
    [0.2722287168, 0.6740817658, 0.0536895174],
    [-0.0055746495, 0.0040607335, 1.0103391003]])
_SRGB_TO_AP1 = _XYZ_TO_AP1 @ _D65_TO_D60 @ _SRGB_TO_XYZ
_AP1_TO_SRGB = np.linalg.inv(_SRGB_TO_AP1)
_AP1_RGB2Y = _AP1_TO_XYZ[1]


def filmic_curve(settings: TonemappingSettings):
    """The filmic curve's host constants, Python floats (float64):
    (toe_scale, shoulder_scale, toe_match, straight_match, shoulder_match)."""
    slope, toe, shoulder = settings.slope, settings.toe, settings.shoulder
    black_clip, white_clip = settings.black_clip, settings.white_clip
    toe_scale = 1.0 + black_clip - toe
    shoulder_scale = 1.0 + white_clip - shoulder
    in_match, out_match = 0.18, 0.18
    if toe > 0.8:
        toe_match = (1.0 - toe - out_match) / slope + np.log10(in_match)
    else:
        bt = (out_match + black_clip) / toe_scale - 1.0
        toe_match = (np.log10(in_match)
                     - 0.5 * np.log((1.0 + bt) / (1.0 - bt)) * (toe_scale / slope))
    toe_match = float(toe_match)
    straight_match = (1.0 - toe) / slope - toe_match
    shoulder_match = shoulder / slope - straight_match
    return toe_scale, shoulder_scale, toe_match, straight_match, shoulder_match


def filmic(color, settings: TonemappingSettings = TonemappingSettings.aces()):
    """UE4-style filmic with ACES defaults (CameraEffects.h:161-217)."""
    slope = settings.slope
    black_clip, white_clip = settings.black_clip, settings.white_clip
    rgb2y = _mat(_AP1_RGB2Y, color)

    working = torch.clamp_min(color @ _mat(_SRGB_TO_AP1.T, color), 0.0)
    gray = torch.sum(working * rgb2y, dim=-1, keepdim=True)
    working = lerp(gray, working, 0.96)

    (toe_scale, shoulder_scale, toe_match, straight_match,
     shoulder_match) = filmic_curve(settings)

    log_color = torch.log10(torch.clamp_min(working, 1e-10))
    straight = (log_color + straight_match) * slope
    toe_color = (-black_clip) + (2.0 * toe_scale) / (
        1.0 + torch.exp((log_color - toe_match) * (-2.0 * slope / toe_scale)))
    toe_color = torch.where(log_color < toe_match, toe_color, straight)
    shoulder_color = (1.0 + white_clip) - (2.0 * shoulder_scale) / (
        1.0 + torch.exp((log_color - shoulder_match)
                        * (2.0 * slope / shoulder_scale)))
    shoulder_color = torch.where(log_color > shoulder_match, shoulder_color,
                                 straight)

    denom = shoulder_match - toe_match
    if abs(denom) < 1e-10:
        denom = 1e-10
    t = torch.clamp((log_color - toe_match) / denom, 0.0, 1.0)
    if shoulder_match < toe_match:
        t = 1.0 - t
    t = (3.0 - 2.0 * t) * t * t
    tone = lerp(toe_color, shoulder_color, t)

    gray = torch.sum(tone * rgb2y, dim=-1, keepdim=True)
    tone = lerp(gray, tone, 0.93)
    return torch.clamp_min(tone, 0.0) @ _mat(_AP1_TO_SRGB.T, color)


# -- AgX ---------------------------------------------------------------------------

_LINEAR_TO_AGX = np.asarray([
    [0.842479062253094, 0.0784335999999992, 0.0792237451477643],
    [0.0423282422610123, 0.878468636469772, 0.0791661274605434],
    [0.0423756549057051, 0.0784336, 0.879142973793104]])
_AGX_TO_TONEMAPPED = np.asarray([
    [1.19687900512017, -0.0980208811401368, -0.0990297440797205],
    [-0.0528968517574562, 1.15190312990417, -0.0989611768448433],
    [-0.0529716355144438, -0.0980434501171241, 1.15107367264116]])


def _agx_contrast(c):
    return -0.00232 + c * (0.1191 + c * (0.4298 + c * (
        -6.868 + c * (31.96 + c * (-40.14 + c * 15.5)))))


def agx(color):
    """AgX (CameraEffects.h:233-258)."""
    c = color @ _mat(_LINEAR_TO_AGX.T, color)
    min_ev, max_ev = -12.47393, 4.026069
    c = torch.log2(torch.clamp_min(c, 1e-10))
    c = (c - min_ev) / (max_ev - min_ev)
    c = _agx_contrast(torch.clamp(c, 0.0, 1.0))
    c = c @ _mat(_AGX_TO_TONEMAPPED.T, color)
    return torch.pow(torch.clamp_min(c, 0.0), 2.2)


# -- Khronos PBR neutral ------------------------------------------------------

def khronos_neutral(color):
    """Khronos commerce tone mapping (CameraEffects.h:265-282)."""
    start_compression = 0.8 - 0.04
    desaturation = 0.15
    x = torch.amin(color, dim=-1, keepdim=True)
    offset = torch.where(x < 0.08, x - 6.25 * x * x, 0.04)
    c = color - offset
    peak = torch.amax(c, dim=-1, keepdim=True)
    d = 1.0 - start_compression
    new_peak = 1.0 - d * d / (peak + d - start_compression)
    compressed = c * new_peak / torch.clamp_min(peak, 1e-10)
    g = 1.0 - 1.0 / (desaturation * (peak - new_peak) + 1.0)
    compressed = lerp(compressed, new_peak, g)
    return torch.where(peak < start_compression, c, compressed)


def apply_tonemap(color, mode: int,
                  settings: TonemappingSettings = TonemappingSettings.aces()):
    if mode == TONEMAP_LINEAR:
        return color
    if mode == TONEMAP_FILMIC:
        return filmic(color, settings)
    if mode == TONEMAP_AGX:
        return agx(color)
    if mode == TONEMAP_KHRONOS_NEUTRAL:
        return khronos_neutral(color)
    raise ValueError(f"unknown tonemapping mode {mode}")
