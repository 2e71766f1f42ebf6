"""Dual-kawase bloom, eye adaptation and the stateful post chain against
the JAX package, on the CPU.

``eye_adaptation`` and ``dual_kawase_bloom`` are deterministic and gated
with ``assert_f64_anchored``. ``process_stateful`` over three frames (each
frame's applied exposure fed back as the next one's previous exposure)
keeps test_torch_post.py's float32 allclose at 1e-5: its histogram
exposure counts pixels into bins, and a float64 run moves pixels on a bin
edge into the next bin, so the chain has no float64 anchor.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifrost3d_tpu.post import bloom as jbloom
from bifrost3d_tpu.post import exposure as jexp
from bifrost3d_tpu.post import pipeline as jpipe
from bifrost3d_tpu.post import tonemap as jtm

from bifrost3d_tpu_torch.post import bloom as tbloom
from bifrost3d_tpu_torch.post import exposure as texp
from bifrost3d_tpu_torch.post import pipeline as tpipe
from bifrost3d_tpu_torch.post import tonemap as ttm
from torch_parity import assert_f64_anchored


def _hdr(seed, h=24, w=32):
    rng = np.random.default_rng(seed)
    img = np.exp(rng.normal(-1.0, 1.5, size=(h, w, 3))).astype(np.float32)
    img[3, 5] = 40.0      # a highlight for bloom
    img[h - 1, w - 1] = 25.0
    return img


def _port_settings(settings):
    port = ttm.CameraEffectsSettings(**{
        f: getattr(settings, f) for f in ttm.CameraEffectsSettings._fields})
    return port._replace(tonemapping=ttm.TonemappingSettings(
        *settings.tonemapping))


def test_settings_fields_are_jax_fields():
    assert ttm.CameraEffectsSettings._fields == \
        jtm.CameraEffectsSettings._fields
    assert ttm.CameraEffectsSettings() == _port_settings(
        jtm.CameraEffectsSettings())


def test_eye_adaptation():
    rng = np.random.default_rng(3)
    n = 4096
    current = np.exp(rng.normal(0.0, 1.0, n)).astype(np.float32)
    target = np.exp(rng.normal(0.0, 1.0, n)).astype(np.float32)
    target[:2] = current[:2]
    dt = rng.uniform(0.0, 0.5, n).astype(np.float32)
    assert_f64_anchored(texp.eye_adaptation, jexp.eye_adaptation,
                        current, target, dt)
    assert_f64_anchored(
        lambda c, t, d: texp.eye_adaptation(c, t, d, 5.0, 0.5),
        lambda c, t, d: jexp.eye_adaptation(c, t, d, 5.0, 0.5),
        current, target, dt)


@pytest.mark.parametrize("shape, half_passes", [
    ((24, 32), 1), ((37, 21), 2), ((32, 48), 3)])
def test_dual_kawase_bloom(shape, half_passes):
    img = _hdr(sum(shape) + half_passes, *shape)
    assert_f64_anchored(
        lambda x: tbloom.dual_kawase_bloom(x, 1.0, half_passes),
        lambda x: jbloom.dual_kawase_bloom(x, 1.0, half_passes), img)


def test_dual_kawase_disabled_passes_through():
    img = torch.tensor(_hdr(0))
    assert tbloom.dual_kawase_bloom(img, float("inf")) is img
    assert tbloom.dual_kawase_bloom(img, 1.0, 0) is img


@pytest.mark.parametrize("bloom_mode", [0, 1], ids=["gaussian", "kawase"])
def test_process_stateful_three_frames(bloom_mode):
    """Three frames whose brightness changes, each with the exposure of the
    last: the first snaps to its target, the others adapt toward theirs at
    the brightening / darkening speeds."""
    settings = jtm.CameraEffectsSettings.preset()._replace(
        bloom_mode=bloom_mode, bloom_threshold=2.0, bloom_support=0.1,
        film_grain=1.0 / 255.0)
    port_settings = _port_settings(settings)
    previous_j, previous_t = -1.0, -1.0
    exposures = []
    for frame, scale in enumerate((1.0, 4.0, 0.25)):
        img = _hdr(10 + frame) * scale
        ref, ref_exp = jpipe.process_stateful(jnp.asarray(img), settings,
                                              frame, previous_j, 1.0 / 30)
        got, got_exp = tpipe.process_stateful(torch.tensor(img),
                                              port_settings, frame,
                                              previous_t, 1.0 / 30)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(float(got_exp), float(ref_exp), rtol=1e-5)
        previous_j, previous_t = ref_exp, got_exp
        exposures.append(float(got_exp))
    # Adaptation lags: frame 2 did not reach its target.
    target = float(texp.histogram_exposure(torch.tensor(_hdr(11) * 4.0)))
    assert exposures[1] != pytest.approx(target, rel=1e-3)


def test_process_is_stateful_first_frame():
    img = _hdr(5)
    settings = ttm.CameraEffectsSettings.preset()._replace(bloom_mode=1,
                                                           bloom_threshold=2.0)
    ldr = tpipe.process(torch.tensor(img), settings, frame_index=2)
    first, _ = tpipe.process_stateful(torch.tensor(img), settings, 2, -1.0,
                                      0.1)
    torch.testing.assert_close(ldr, first, rtol=0, atol=0)
