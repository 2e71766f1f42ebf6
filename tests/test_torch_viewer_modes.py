"""The viewer's modes end to end on the CPU, and the EnvironmentConvolution
app against the JAX package's.

``--checkpoint-dir``: a run of -n 4 that checkpoints every 2, then a run
of -n 6 from the same directory, which says it resumed at accumulation 4
and writes the image of an uninterrupted -n 6 run bit for bit (EXR
output, the linear post chain's values). A checkpoint of another scene,
or one at or past -n, is not resumed. ``--renderer preview`` and
``--renderer denoised`` write the post chain of ``render_preview`` and of
``DenoisedBackend``'s last image. ``environment_convolution`` on a seeded
64 × 32 EXR sky writes the levels of the JAX app (float32 allclose at
2e-5: both convolve in float32 through their own elementary functions).
"""

import os

import numpy as np
import pytest
import torch

from bifrost3d_tpu.apps import environment_convolution as japp

from bifrost3d_tpu_torch.apps import environment_convolution as tapp
from bifrost3d_tpu_torch.apps import simple_viewer
from bifrost3d_tpu_torch.apps.scenes import SCENES
from bifrost3d_tpu_torch.integrator.backend import DenoisedBackend
from bifrost3d_tpu_torch.integrator.path_tracer import RenderSettings
from bifrost3d_tpu_torch.io import image as timage
from bifrost3d_tpu_torch.post.pipeline import process
from bifrost3d_tpu_torch.post.tonemap import CameraEffectsSettings
from bifrost3d_tpu_torch.preview import render_preview
import torch_parity  # noqa: F401  (one torch thread per worker)

BASE = ["--device", "cpu", "--window-size", "8x8"]
POST = CameraEffectsSettings.preset()._replace(film_grain=0.0)


def _run(argv, capsys):
    simple_viewer.main(BASE + argv)
    return capsys.readouterr().out


def test_checkpoint_resume_is_bit_equal(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    first = str(tmp_path / "first.exr")
    said = _run(["-n", "4", "--checkpoint-dir", ckpt, "--checkpoint-every",
                 "2", "-o", first], capsys)
    assert "resumed at" not in said
    assert sorted(os.listdir(ckpt)) == ["ckpt_2.npz", "ckpt_4.npz"]
    resumed = str(tmp_path / "resumed.exr")
    said = _run(["-n", "6", "--checkpoint-dir", ckpt, "--checkpoint-every",
                 "2", "-o", resumed], capsys)
    assert "resumed at accumulation 4" in said
    assert sorted(os.listdir(ckpt)) == ["ckpt_2.npz", "ckpt_4.npz",
                                        "ckpt_6.npz"]
    whole = str(tmp_path / "whole.exr")
    _run(["-n", "6", "-o", whole], capsys)
    got, ref = timage.load_exr(resumed), timage.load_exr(whole)
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
    assert not np.array_equal(got, timage.load_exr(first))


@pytest.mark.parametrize("scene, n", [("Veach", 6), ("CornellBox", 4)])
def test_checkpoint_not_resumed(tmp_path, capsys, scene, n):
    """Another scene's checkpoint, or one at -n, starts afresh."""
    ckpt = str(tmp_path / "ckpt")
    _run(["-n", "4", "--checkpoint-dir", ckpt, "-o",
          str(tmp_path / "a.png")], capsys)
    said = _run(["--scene", scene, "-n", str(n), "--checkpoint-dir", ckpt,
                 "-o", str(tmp_path / "b.png")], capsys)
    assert "resumed at" not in said


def test_preview_and_denoised_write_their_renderers(tmp_path, capsys):
    scene, cam = SCENES["CornellBox"](aspect=1.0, device="cpu")
    scene = scene._replace(environment_tint=torch.tensor(
        (0.68, 0.92, 1.0), dtype=torch.float32))
    preview = str(tmp_path / "preview.exr")
    said = _run(["--renderer", "preview", "-o", preview], capsys)
    assert "preview 8x8" in said
    ref = process(render_preview(scene, cam, 8, 8), POST).numpy()
    np.testing.assert_array_equal(timage.load_exr(preview), ref)
    denoised = str(tmp_path / "denoised.exr")
    said = _run(["--renderer", "denoised", "-n", "3", "--max-bounces", "2",
                 "-o", denoised], capsys)
    assert "denoised 8x8 n=3" in said
    backend = DenoisedBackend(scene, cam, 8, 8,
                              RenderSettings(max_bounce_count=2))
    for _ in range(3):
        hdr = backend.render()
    np.testing.assert_array_equal(timage.load_exr(denoised),
                                  process(hdr, POST).numpy())


def test_path_regularization_flag_changes_the_frame(tmp_path, capsys):
    plain, reg = str(tmp_path / "plain.exr"), str(tmp_path / "reg.exr")
    _run(["--scene", "MaterialSceneLegacy", "-n", "1", "-o", plain], capsys)
    _run(["--scene", "MaterialSceneLegacy", "-n", "1",
          "--path-regularization", "1.0", "-o", reg], capsys)
    a, b = timage.load_exr(plain), timage.load_exr(reg)
    assert np.isfinite(b).all() and not np.array_equal(a, b)


def _sky(h=32, w=64):
    rng = np.random.default_rng(11)
    sky = np.exp(rng.normal(-0.5, 0.7, (h, w, 3))).astype(np.float32)
    sky[5, 20] = 80.0
    return sky


def test_environment_convolution_matches_jax_app(tmp_path, capsys):
    exr = str(tmp_path / "sky.exr")
    timage.save_exr(exr, _sky())
    args = [exr, "--roughness", "0.0,0.5,1.0", "--samples", "32"]
    japp.main(args + ["--output-dir", str(tmp_path / "jax")])
    tapp.main(args + ["--output-dir", str(tmp_path / "port"), "--device",
                      "cpu"])
    said = capsys.readouterr().out
    assert "convolved 3 levels on cpu" in said
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        "sky_ggx_0.00.exr", "sky_ggx_0.50.exr", "sky_ggx_1.00.exr"]
    sizes = []
    for name in names:
        ref = timage.load_exr(str(tmp_path / "jax" / name))
        got = timage.load_exr(str(tmp_path / "port" / name))
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-6)
        sizes.append(got.shape[:2])
    assert sizes == [(32, 64), (16, 32), (16, 32)]


def test_environment_convolution_png_input(tmp_path, capsys):
    png = str(tmp_path / "sky.png")
    timage.save_image(png, np.clip(_sky(16, 32) / 4.0, 0.0, 1.0))
    tapp.main([png, "--roughness", "0.0,1.0", "--samples", "8",
               "--output-dir", str(tmp_path / "out"), "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "out")) == [
        "sky_ggx_0.00.png", "sky_ggx_1.00.png"]
    assert "roughness 1.00: 32x16" in capsys.readouterr().out
