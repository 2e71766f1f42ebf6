"""The post chain's kernel wrapper (post/post_chain.py) on the CPU.

A CPU image takes the eager chain and launches nothing. The kernels
cannot run here, so their host side is checked through a plain per-pixel
PyTorch mirror of ``csrc/post_chain.cu``'s arithmetic, fed the constants
``apply_params`` and ``exposure_params`` pack (float32, as the kernels get
them): it has to reproduce the eager chain's tonemappers, vignette, grain
and exposure. The mirror divides by a number as the kernel does (times the
float32 reciprocal) and takes the 3 x 3 products as FMA chains where the
eager chain on the CPU divides and calls a GEMM, so the two agree to a few
float32 roundings, not bit for bit: 2e-6 absolute on [0, 1] output, 1e-6
relative on the exposure, and 1e-5 for AgX, whose contrast polynomial
(slope up to ~20) and 2.2 power amplify the one-ulp gap between dividing
by (max_ev - min_ev) and multiplying by its reciprocal (5.2e-6 seen). The
card tests (test_torch_post_cuda.py) hold the kernels themselves against
the eager chain on the card, which also multiplies by the reciprocal.
"""

import numpy as np
import pytest
import torch

from bifrost3d_tpu_torch.post import pipeline, post_chain
from bifrost3d_tpu_torch.post import tonemap as tm
from bifrost3d_tpu_torch.post.exposure import HISTOGRAM_BINS
from bifrost3d_tpu_torch.post.tonemap import (
    EXPOSURE_FIXED,
    EXPOSURE_HISTOGRAM,
    EXPOSURE_LOG_AVERAGE,
    CameraEffectsSettings,
    TonemappingSettings,
)
import torch_parity  # noqa: F401  (one torch thread per worker)

H, W = 24, 32
LUMA = (0.2126, 0.7152, 0.0722)


def tolerance(tonemap: int) -> float:
    return 1e-5 if tonemap == tm.TONEMAP_AGX else 2e-6


@pytest.fixture(scope="module")
def hdr():
    rng = np.random.default_rng(11)
    img = np.exp(rng.normal(-1.0, 1.5, size=(H, W, 3))).astype(np.float32)
    img[0, 0] = 0.0
    img[3, 5] = 40.0
    return torch.tensor(img)


def f32(x):
    return torch.tensor(float(x), dtype=torch.float32)


def fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def mat3(c, m):
    m = [f32(v) for v in m]
    return torch.stack([fma(c[..., 2], m[3 * j + 2],
                            fma(c[..., 1], m[3 * j + 1], c[..., 0] * m[3 * j]))
                        for j in range(3)], dim=-1)


def dot3(c, w):
    w = [f32(v) for v in w]
    return (c[..., 0] * w[0] + c[..., 2] * w[2]) + c[..., 1] * w[1]


def lerp(a, b, t):
    return a + (b - a) * t


def rcp(x):
    return f32(1.0) / x


def mirror_filmic(c, p):
    w = torch.clamp_min(mat3(c, p.m_in), 0.0)
    gray = dot3(w, p.rgb2y)[..., None]
    working = lerp(gray, w, f32(0.96))
    lc = torch.log10(torch.clamp_min(working, f32(1e-10)))
    straight = (lc + f32(p.straight_match)) * f32(p.slope)
    toe = f32(p.neg_black_clip) + rcp(f32(1.0) + torch.exp(
        (lc - f32(p.toe_match)) * f32(p.toe_rate))) * f32(p.toe_numerator)
    toe = torch.where(lc < f32(p.toe_match), toe, straight)
    shoulder = f32(p.white_one) - rcp(f32(1.0) + torch.exp(
        (lc - f32(p.shoulder_match)) * f32(p.shoulder_rate))) \
        * f32(p.shoulder_numerator)
    shoulder = torch.where(lc > f32(p.shoulder_match), shoulder, straight)
    t = torch.clamp((lc - f32(p.toe_match)) * f32(p.inv_denom), 0.0, 1.0)
    if p.flip:
        t = f32(1.0) - t
    t = ((f32(3.0) - f32(2.0) * t) * t) * t
    tone = lerp(toe, shoulder, t)
    gray = dot3(tone, p.rgb2y)[..., None]
    return mat3(torch.clamp_min(lerp(gray, tone, f32(0.93)), 0.0), p.m_out)


def mirror_agx(c, p):
    x = torch.log2(torch.clamp_min(mat3(c, p.m_in), f32(1e-10)))
    x = torch.clamp((x - f32(p.min_ev)) * f32(p.inv_ev_range), 0.0, 1.0)
    y = x * f32(15.5)
    for k in (-40.14, 31.96, -6.868, 0.4298, 0.1191):
        y = x * (y + f32(k))
    y = y + f32(-0.00232)
    return torch.pow(torch.clamp_min(mat3(y, p.m_out), 0.0), f32(2.2))


def mirror_khronos(c, p):
    x = torch.amin(c, dim=-1, keepdim=True)
    offset = torch.where(x < f32(0.08), x - (x * f32(6.25)) * x, f32(0.04))
    d = c - offset
    peak = torch.amax(d, dim=-1, keepdim=True)
    new_peak = f32(1.0) - rcp((peak + f32(p.compression_d))
                              - f32(p.start_compression)) \
        * f32(p.compression_dd)
    g = f32(1.0) - rcp((peak - new_peak) * f32(p.desaturation) + f32(1.0))
    compressed = lerp(d * new_peak / torch.clamp_min(peak, f32(1e-10)),
                      new_peak, g)
    return torch.where(peak < f32(p.start_compression), d, compressed)


def mirror_grain(p):
    """csrc/post_chain.cu grain_noise in uint32 (numpy) → [H, W] noise."""
    m, inc = np.uint32(1664525), np.uint32(1013904223)
    with np.errstate(over="ignore"):
        hx = (np.arange(W, dtype=np.uint32)[None, :] * np.uint32(9781)
              + np.uint32(p.grain_x)) + np.zeros((H, 1), np.uint32)
        hy = (np.arange(H, dtype=np.uint32)[:, None] * np.uint32(6271)
              + np.uint32(p.grain_y)) + np.zeros((1, W), np.uint32)
        hx = hx * m + inc
        hy = hy * m + inc
        hx = hx + hy * m
        hy = hy + hx * m
        hx ^= hx >> np.uint32(16)
        hy ^= hy >> np.uint32(16)
        hx = hx + hy * m
    hx ^= hx >> np.uint32(16)
    return torch.tensor(hx.astype(np.float32)) * f32(2.0 ** -32) - f32(0.5)


def mirror_apply(image, exposure: float, p):
    """apply_kernel of csrc/post_chain.cu over a CPU image."""
    c = image * f32(exposure)
    if p.vignette_on:
        xs = (torch.arange(W, dtype=torch.float32) + f32(0.5)) \
            * f32(p.inv_width) - f32(0.5)
        ys = (torch.arange(H, dtype=torch.float32) + f32(0.5)) \
            * f32(p.inv_height) - f32(0.5)
        r2 = (xs[None, :] * xs[None, :] + ys[:, None] * ys[:, None]) * f32(2.0)
        falloff = torch.clamp(f32(1.0) - r2 * f32(p.vignette), 0.0, 1.0)
        c = c * falloff[..., None]
    c = {tm.TONEMAP_LINEAR: lambda c, p: c, tm.TONEMAP_FILMIC: mirror_filmic,
         tm.TONEMAP_AGX: mirror_agx,
         tm.TONEMAP_KHRONOS_NEUTRAL: mirror_khronos}[p.tonemap](c, p)
    if p.grain_on:
        c = c + (mirror_grain(p) * f32(p.grain_scale))[..., None]
    return torch.clamp(c, 0.0, 1.0)


def mirror_exposure(image, p) -> float:
    """exposure_kernel's target and eye adaptation, in float32 (numpy)."""
    f = np.float32
    lum = dot3(image, LUMA).reshape(-1)
    if p.mode == EXPOSURE_HISTOGRAM:
        log_lum = torch.log2(torch.clamp_min(lum, f32(1e-10)))
        x = (log_lum - f32(p.min_log)) * f32(p.inv_log_range) \
            * f32(HISTOGRAM_BINS)
        bins = torch.clamp(x, 0.0, HISTOGRAM_BINS - 1).to(torch.int64)
        hist = torch.bincount(bins, minlength=HISTOGRAM_BINS).numpy()
        total = f(hist.sum())
        lo, hi = total * f(p.min_percentage), total * f(p.max_percentage)
        before, weighted, weight = f(0.0), 0.0, 0.0
        for i, count in enumerate(hist):
            after = before + f(count)
            c = min(max(hi, before), after) - min(max(lo, before), after)
            centre = (f(i) + f(0.5)) * f(1.0 / HISTOGRAM_BINS)
            bin_lum = np.exp2(centre * f(p.log_range) + f(p.min_log))
            weighted += float(c * bin_lum)
            weight += float(c)
            before = after
        avg = f(weighted) / max(f(weight), f(1e-6))
        target = (f(1.0) / max(avg, f(1e-6))) * f(p.bias_scale)
    elif p.mode == EXPOSURE_LOG_AVERAGE:
        mean = torch.log(torch.clamp_min(lum, f32(1e-6))).double().mean()
        log_avg = np.exp(f(mean))
        key = f(1.03) - (f(1.0) / (f(2.0) + np.log10(log_avg + f(1.0)))) \
            * f(2.0)
        target = key / max(log_avg, f(1e-6)) * f(p.bias_scale)
    else:
        target = np.exp2(f(p.bias))
    if not p.adapt or p.previous < 0.0:
        return float(target)
    delta = target - f(p.previous)
    speed = f(p.brightness) if delta > 0 else f(p.darkness)
    factor = f(1.0) - np.exp2(-f(p.delta_time) * speed)
    return float(f(p.previous) + delta * factor)


@pytest.mark.parametrize("exposure_mode", [EXPOSURE_FIXED,
                                           EXPOSURE_LOG_AVERAGE,
                                           EXPOSURE_HISTOGRAM])
def test_cpu_image_takes_the_plain_path(hdr, exposure_mode):
    settings = CameraEffectsSettings.preset()._replace(
        exposure_mode=exposure_mode)
    before = post_chain.launch_count
    ldr, exposure = pipeline.process_stateful(hdr, settings, 3, 0.5, 1 / 60)
    plain, plain_exposure = pipeline._process_plain(hdr, settings, 3, 0.5,
                                                    1 / 60)
    assert post_chain.launch_count == before
    assert torch.equal(ldr, plain) and torch.equal(exposure, plain_exposure)


def test_kernels_refuse_a_cpu_image_and_unknown_modes(hdr):
    settings = CameraEffectsSettings.preset()
    with pytest.raises(ValueError, match="CUDA"):
        post_chain.exposure_cuda(hdr, settings, -1.0, 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        post_chain.apply_cuda(hdr, 1.0, settings, 0)
    with pytest.raises(ValueError, match="exposure mode"):
        post_chain.exposure_params(settings._replace(exposure_mode=7), 4,
                                   -1.0, 0.0)
    with pytest.raises(ValueError, match="tonemapping mode"):
        post_chain.apply_params(settings._replace(tonemapping_mode=9), 4, 4, 0)


FILMIC_SETTINGS = [TonemappingSettings.aces(),                      # flip
                   TonemappingSettings(0.0, 0.55, 0.63, 0.47, 0.01),
                   TonemappingSettings(0.02, 0.85, 0.91, 0.23, 0.035)]


@pytest.mark.parametrize("settings", FILMIC_SETTINGS,
                         ids=["aces", "no_flip", "toe_above_0.8"])
def test_filmic_packing_reproduces_filmic(hdr, settings):
    p = post_chain.apply_params(CameraEffectsSettings.preset()._replace(
        tonemapping=settings), W, H, 0)
    curve = tm.filmic_curve(settings)
    assert p.flip == int(curve[4] < curve[2])
    assert np.float32(p.toe_match) == np.float32(curve[2])
    assert list(p.m_in) == np.float32(tm._SRGB_TO_AP1).reshape(9).tolist()
    assert list(p.m_out) == np.float32(tm._AP1_TO_SRGB).reshape(9).tolist()
    got = mirror_filmic(hdr, p)
    ref = tm.filmic(hdr, settings)
    assert float((got - ref).abs().max()) <= 2e-6 * max(1.0, float(
        ref.abs().max()))


@pytest.mark.parametrize("tonemap", [tm.TONEMAP_AGX,
                                     tm.TONEMAP_KHRONOS_NEUTRAL])
def test_agx_and_khronos_packing(hdr, tonemap):
    p = post_chain.apply_params(CameraEffectsSettings.preset()._replace(
        tonemapping_mode=tonemap), W, H, 0)
    got = {tm.TONEMAP_AGX: mirror_agx,
           tm.TONEMAP_KHRONOS_NEUTRAL: mirror_khronos}[tonemap](hdr, p)
    ref = tm.apply_tonemap(hdr, tonemap)
    assert float((got - ref).abs().max()) <= tolerance(tonemap) * max(
        1.0, float(ref.abs().max()))


@pytest.mark.parametrize("tonemap", [tm.TONEMAP_LINEAR, tm.TONEMAP_FILMIC,
                                     tm.TONEMAP_AGX,
                                     tm.TONEMAP_KHRONOS_NEUTRAL])
@pytest.mark.parametrize("vignette,grain", [(0.0, 0.0), (0.63, 1 / 255)])
def test_apply_mirror_matches_the_eager_chain(hdr, tonemap, vignette, grain):
    settings = CameraEffectsSettings.preset()._replace(
        exposure_mode=EXPOSURE_FIXED, log_luminance_bias=0.5,
        eye_adaptation_enabled=False, tonemapping_mode=tonemap,
        vignette=vignette, film_grain=grain)
    p = post_chain.apply_params(settings, W, H, 7)
    ref, exposure = pipeline._process_plain(hdr, settings, 7, -1.0, 0.0)
    got = mirror_apply(hdr, float(exposure), p)
    assert float((got - ref).abs().max()) <= tolerance(tonemap)


@pytest.mark.parametrize("exposure_mode", [EXPOSURE_FIXED,
                                           EXPOSURE_LOG_AVERAGE,
                                           EXPOSURE_HISTOGRAM])
@pytest.mark.parametrize("previous", [-1.0, 0.3, 4.0])
def test_exposure_packing_reproduces_the_exposure(hdr, exposure_mode,
                                                  previous):
    settings = CameraEffectsSettings.preset()._replace(
        exposure_mode=exposure_mode, log_luminance_bias=-0.25,
        min_histogram_percentage=0.6)
    p, held = post_chain.exposure_params(settings, H * W, previous, 0.1)
    assert held == (None, None) and not p.previous_ptr
    _, ref = pipeline._process_plain(hdr, settings, 0, previous, 0.1)
    got = mirror_exposure(hdr, p)
    assert abs(got / float(ref) - 1.0) <= 1e-6


def test_exposure_params_read_a_cpu_tensor_on_the_host():
    settings = CameraEffectsSettings.preset()
    p, held = post_chain.exposure_params(settings, 16, torch.tensor(0.75),
                                         torch.tensor(0.5))
    assert held == (None, None)
    assert (p.previous, p.delta_time) == (0.75, 0.5)
    assert not p.previous_ptr and not p.delta_time_ptr
