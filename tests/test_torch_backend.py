"""The render backends (integrator/backend.py) against the JAX package, on
the CPU.

``atrous_denoise`` is deterministic and gated with ``assert_f64_anchored``
(a noisy image with its normal and albedo guides, 4 iterations, taps
wrapping around the edges as ``jnp.roll``'s). ``DenoisedBackend`` renders
CornellBox at 16², 2 bounces, for 3 frames in both packages, from the same
scene arrays: the running means under the statistical gate of
tests/test_pallas_mesh.py:25-42 (≤ 3% of pixels off by more than 1e-3,
means within 2%), the AOVs equal on ≥ 97% of the pixels (the rest are
edge pixels where one trace hits and the other misses: 4 of 256), and
each returned image equal at 1e-5 to JAX's denoiser run on the port's
own running mean and AOVs, with the presentation cadence of both (frames
1 and 2 denoised, frame 3 the frame-2 image again); the denoised images'
means within 2%. The denoised images themselves are not held pixel by
pixel: the filter spreads each of the four edge pixels over its 61 × 61
footprint (20% of pixels off by up to 0.12).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifrost3d_tpu.apps.scenes import create_cornell_box as jax_cornell_box
from bifrost3d_tpu.integrator import backend as jbackend
from bifrost3d_tpu.integrator import path_tracer as jpt

from bifrost3d_tpu_torch.integrator import backend as tbackend
from bifrost3d_tpu_torch.integrator import path_tracer as tpt
from bifrost3d_tpu_torch.scene.camera import camera_from_numpy
from bifrost3d_tpu_torch.scene.render_scene import render_scene_from_numpy
from torch_parity import (
    assert_f64_anchored,
    assert_statistical_gate,
    camera_arrays,
    scene_arrays,
)

RES = 16
FRAMES = 3


def _guides(seed, h=24, w=20, noise=1.0):
    rng = np.random.default_rng(seed)
    color = np.exp(rng.normal(-1.0, noise, (h, w, 3))).astype(np.float32)
    normal = rng.normal(size=(h, w, 3))
    normal[: h // 2] = (0.0, 1.0, 0.0)            # a flat region
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    albedo = rng.random((h, w, 3)).astype(np.float32)
    albedo[:, : w // 3] = 0.5
    return color, normal.astype(np.float32), albedo


@pytest.mark.parametrize("iterations", [1, 4])
def test_atrous_denoise_matches_jax(iterations):
    color, normal, albedo = _guides(iterations)
    assert_f64_anchored(
        lambda c, n, a: tbackend.atrous_denoise(c, n, a, iterations),
        lambda c, n, a: jbackend.atrous_denoise(c, n, a, iterations),
        color, normal, albedo)


def test_atrous_denoise_smooths_flat_regions():
    color, normal, albedo = (torch.tensor(x) for x in _guides(7, noise=0.1))
    out = tbackend.atrous_denoise(color, normal, albedo)
    flat = slice(0, 12), slice(0, 6)
    assert float(out[flat].std()) < 0.5 * float(color[flat].std())


@pytest.mark.parametrize("n, denoise", [
    (0, False), (1, True), (2, True), (3, False), (4, True), (31, False),
    (32, True), (33, False), (64, True), (96, True)])
def test_should_denoise_cadence(n, denoise):
    """Power-of-two frames or every 32nd, as JAX's expression reads; with
    no denoised image yet, always."""
    ref = jbackend.DenoisedBackend.__new__(jbackend.DenoisedBackend)
    got = tbackend.DenoisedBackend.__new__(tbackend.DenoisedBackend)
    for b in (ref, got):
        b.accumulations, b._denoised = n, "an image"
    assert got._should_denoise() == ref._should_denoise() == denoise
    ref._denoised = got._denoised = None
    assert got._should_denoise() and ref._should_denoise()


@pytest.fixture(scope="module")
def jax_frames():
    scene, cam = jax_cornell_box()
    backend = jbackend.DenoisedBackend(
        scene, cam, RES, RES, jpt.RenderSettings(max_bounce_count=2))
    frames = []
    for _ in range(FRAMES):
        out = backend.render()
        frames.append((np.asarray(out), np.asarray(backend.buffer)))
    aovs = {k: np.asarray(v) for k, v in backend._aovs.items()}
    return scene, cam, frames, aovs


def test_denoised_backend_matches_jax(jax_frames):
    jscene, jcam, refs, jaovs = jax_frames
    scene = render_scene_from_numpy(scene_arrays(jscene), device="cpu")
    cam = camera_from_numpy(camera_arrays(jcam), device="cpu")
    backend = tbackend.DenoisedBackend(
        scene, cam, RES, RES, tpt.RenderSettings(max_bounce_count=2))
    frames, means = [], []
    for (ref, ref_buffer) in refs:
        img = backend.render()
        frames.append(img)
        means.append(backend.buffer.clone())
        assert_statistical_gate(backend.buffer.numpy(), ref_buffer)
        assert abs(float(img.mean()) - ref.mean()) < 0.02 * ref.mean()
    for key in ("albedo", "shading_normal"):
        d = np.abs(backend._aovs[key].numpy() - jaovs[key]).max(-1)
        assert (d > 1e-3).mean() <= 0.03, key
    # Frames 1 and 2 are denoised from that frame's running mean with the
    # port's AOVs; frame 3 presents frame 2's image.
    normal = jnp.asarray(backend._aovs["shading_normal"].numpy())
    albedo = jnp.asarray(backend._aovs["albedo"].numpy())
    for img, mean in zip(frames[:2], means[:2]):
        ref = jbackend.atrous_denoise(jnp.asarray(mean.numpy()), normal,
                                      albedo, 4)
        np.testing.assert_allclose(img.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    assert frames[2] is frames[1]
    assert float((frames[1] - means[1]).abs().mean()) > 0.0
    assert backend.accumulations == FRAMES
    backend.reset()
    assert backend.accumulations == 0 and backend._denoised is None


def test_simple_backend_is_the_running_mean(jax_frames):
    jscene, jcam, _, _ = jax_frames
    scene = render_scene_from_numpy(scene_arrays(jscene), device="cpu")
    cam = camera_from_numpy(camera_arrays(jcam), device="cpu")
    settings = tpt.RenderSettings(max_bounce_count=2)
    backend = tbackend.SimpleBackend(scene, cam, 8, 8, settings)
    for _ in range(3):
        out = backend.render()
    ref = tpt.render_progressive(scene, cam, 8, 8, 3, settings)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
