"""The port's post chain and PNG writer against the JAX package.

Tonemaps, exposure and bloom are float32 allclose (filmic within 1e-5, as
tests/test_post.py pins it against the reference); the PNG written with
the standard library reads back through PIL byte for byte.
"""

import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from bifrost3d_tpu.io import image as jimage
from bifrost3d_tpu.post import bloom as jbloom
from bifrost3d_tpu.post import exposure as jexp
from bifrost3d_tpu.post import pipeline as jpipe
from bifrost3d_tpu.post import tonemap as jtm

from bifrost3d_tpu_torch.io import image as timage
from bifrost3d_tpu_torch.post import bloom as tbloom
from bifrost3d_tpu_torch.post import exposure as texp
from bifrost3d_tpu_torch.post import pipeline as tpipe
from bifrost3d_tpu_torch.post import tonemap as ttm
import torch_parity  # noqa: F401  (one torch thread per worker)


@pytest.fixture(scope="module")
def hdr():
    rng = np.random.default_rng(7)
    img = np.exp(rng.normal(-1.0, 1.5, size=(24, 32, 3))).astype(np.float32)
    img[0, 0] = 0.0
    img[3, 5] = 40.0      # a highlight for bloom
    return img


@pytest.mark.parametrize("op", ["filmic", "agx", "khronos_neutral"])
def test_tonemap_operators(hdr, op):
    got = getattr(ttm, op)(torch.tensor(hdr)).numpy()
    ref = np.asarray(getattr(jtm, op)(jnp.asarray(hdr)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_filmic_settings_within_1e5(hdr):
    settings = jtm.TonemappingSettings(0.0, 0.55, 0.63, 0.47, 0.01)
    got = ttm.filmic(torch.tensor(hdr),
                     ttm.TonemappingSettings(*settings)).numpy()
    ref = np.asarray(jtm.filmic(jnp.asarray(hdr), settings))
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_exposures(hdr):
    t, j = torch.tensor(hdr), jnp.asarray(hdr)
    np.testing.assert_array_equal(texp.luminance_histogram(t).numpy(),
                                  np.asarray(jexp.luminance_histogram(j)))
    np.testing.assert_allclose(texp.histogram_exposure(t).numpy(),
                               np.asarray(jexp.histogram_exposure(j)),
                               rtol=1e-5)
    np.testing.assert_allclose(texp.log_average_exposure(t, 0.5).numpy(),
                               np.asarray(jexp.log_average_exposure(j, 0.5)),
                               rtol=1e-5)
    np.testing.assert_allclose(
        texp.fixed_exposure(1.5, device="cpu").numpy(),
        np.asarray(jexp.fixed_exposure(1.5)), rtol=1e-6)


def test_gaussian_bloom(hdr):
    got = tbloom.gaussian_bloom(torch.tensor(hdr), 2.0, 0.1).numpy()
    ref = np.asarray(jbloom.gaussian_bloom(jnp.asarray(hdr), 2.0, 0.1))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    same = tbloom.gaussian_bloom(torch.tensor(hdr), np.inf, 0.1)
    np.testing.assert_array_equal(same.numpy(), hdr)


@pytest.mark.parametrize("settings", [
    jtm.CameraEffectsSettings.preset(),
    jtm.CameraEffectsSettings.preset()._replace(film_grain=0.0),
    jtm.CameraEffectsSettings.preset()._replace(
        bloom_threshold=2.0, exposure_mode=jtm.EXPOSURE_LOG_AVERAGE,
        tonemapping_mode=jtm.TONEMAP_AGX),
    jtm.CameraEffectsSettings.linear(),
], ids=["preset", "no-grain", "bloom-logavg-agx", "linear"])
def test_process_matches_jax(hdr, settings):
    port_settings = ttm.CameraEffectsSettings(**{
        f: getattr(settings, f) for f in ttm.CameraEffectsSettings._fields})
    port_settings = port_settings._replace(
        tonemapping=ttm.TonemappingSettings(*settings.tonemapping))
    got = tpipe.process(torch.tensor(hdr), port_settings, frame_index=3).numpy()
    ref = np.asarray(jpipe.process(jnp.asarray(hdr), settings, frame_index=3))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_dual_kawase_raises(hdr):
    """Dual-kawase bloom is ported (it raised before): ``process`` with
    bloom mode 1 matches JAX's at test_process_matches_jax's 1e-5."""
    settings = jtm.CameraEffectsSettings.preset()._replace(
        bloom_mode=1, bloom_threshold=2.0, bloom_support=0.2)
    port_settings = ttm.CameraEffectsSettings(**{
        f: getattr(settings, f) for f in ttm.CameraEffectsSettings._fields})
    port_settings = port_settings._replace(
        tonemapping=ttm.TonemappingSettings(*settings.tonemapping))
    got = tpipe.process(torch.tensor(hdr), port_settings, frame_index=1)
    ref = jpipe.process(jnp.asarray(hdr), settings, frame_index=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    plain = tpipe.process(torch.tensor(hdr), port_settings._replace(
        bloom_threshold=float("inf")), frame_index=1)
    assert not torch.allclose(got, plain, atol=1e-3)


def test_png_round_trip(tmp_path, hdr):
    ldr = np.clip(hdr / 4.0, 0.0, 1.0)
    path = str(tmp_path / "out.png")
    timage.save_image(path, torch.tensor(ldr))
    back = np.asarray(Image.open(path))
    np.testing.assert_array_equal(back, timage.srgb_encode_u8(ldr))
    # The sRGB encode agrees with the JAX package's (PIL-backed) writer.
    ref_path = str(tmp_path / "ref.png")
    jimage.save_image(ref_path, ldr)
    ref = np.asarray(Image.open(ref_path)).astype(int)
    assert np.abs(back.astype(int) - ref).max() <= 1


def test_png_odd_sizes(tmp_path):
    rng = np.random.default_rng(8)
    for shape in ((1, 1, 3), (5, 7, 3)):
        data = rng.integers(0, 256, size=shape, dtype=np.uint8)
        path = str(tmp_path / f"x{shape[1]}.png")
        timage.write_png(path, data)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), data)
    with pytest.raises(ValueError, match="RGB"):
        timage.write_png(str(tmp_path / "y.png"), data[..., :2])


def test_only_png_output(tmp_path, monkeypatch):
    """PNG and EXR without PIL; other formats through PIL where it is
    installed (the file the JAX package's ``save_image`` writes), and
    without it they raise."""
    img = np.random.default_rng(9).uniform(0, 1, (6, 5, 3)).astype(np.float32)
    timage.save_image(str(tmp_path / "x.bmp"), img)
    jimage.save_image(str(tmp_path / "j.bmp"), img)
    assert (tmp_path / "x.bmp").read_bytes() == (tmp_path / "j.bmp").read_bytes()
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(NotImplementedError, match="jpg"):
        timage.save_image(str(tmp_path / "x.jpg"), np.zeros((2, 2, 3)))
    timage.save_image(str(tmp_path / "x.exr"), np.full((2, 2, 3), 0.5))
    np.testing.assert_array_equal(timage.load_exr(str(tmp_path / "x.exr")),
                                  np.full((2, 2, 3), 0.5, np.float32))
