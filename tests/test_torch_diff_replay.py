"""The port's differentiable entries against the JAX package's, on the
CPU: ``render_sample_pixels`` and ``render_rays`` forward, and the
detached-replay VJP and remat against plain reverse mode.

JAX's scene and settings are those of tests/test_diff.py:17-35, carried
across with ``render_scene_from_numpy``; plain, replay and remat are held
to each other on CornellBox at 16², as JAX's
``test_detached_replay_vjp_matches_plain_ad`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifrost3d_tpu.integrator import path_tracer as jpt
from bifrost3d_tpu.scene.camera import camera_ray_directions as jax_rays

from bifrost3d_tpu_torch.apps.scenes import create_cornell_box
from bifrost3d_tpu_torch.integrator import path_tracer as tpt
from bifrost3d_tpu_torch.scene.camera import camera_from_numpy
from bifrost3d_tpu_torch.scene.render_scene import render_scene_from_numpy
from test_torch_diff_grad import (
    SETTINGS,
    H,
    W,
    make_jax_camera,
    make_jax_scene,
)
from torch_parity import (
    assert_statistical_gate,
    camera_arrays,
    scene_arrays,
)

PORT_SETTINGS = tpt.RenderSettings(*SETTINGS)
# Pixels of the 16 x 12 frame in a [6, 8] block of scattered coordinates.
_RNG = np.random.default_rng(5)
PIXELS = (_RNG.integers(0, W, (6, 8)).astype(np.uint32),
          _RNG.integers(0, H, (6, 8)).astype(np.uint32))


def _port(jax_scene, jax_cam):
    return (render_scene_from_numpy(scene_arrays(jax_scene), device="cpu"),
            camera_from_numpy(camera_arrays(jax_cam), device="cpu"))


@pytest.fixture(scope="module")
def scenes():
    scene, cam = make_jax_scene(), make_jax_camera()
    return scene, cam, *_port(scene, cam)


# -- forward entries -----------------------------------------------------------------

def test_render_sample_pixels_matches_jax(scenes):
    """Scattered pixels at accumulations 0 and 3 against JAX's, under the
    statistical frame gate of tests/test_pallas_mesh.py:25-42 (≤ 3% of
    pixels off by > 1e-3, means within 2%); and the same pixels of the
    port's own render_sample bit for bit."""
    jscene, jcam, scene, cam = scenes
    x, y = PIXELS
    run = jax.jit(lambda acc: jpt.render_sample_pixels(
        jscene, jcam, jnp.asarray(x), jnp.asarray(y), W, H, acc, SETTINGS))
    for acc in (0, 3):
        got = tpt.render_sample_pixels(scene, cam, torch.tensor(x),
                                       torch.tensor(y), W, H, acc,
                                       PORT_SETTINGS)
        assert got.shape == (6, 8, 3)
        assert_statistical_gate(got.numpy(), np.asarray(run(jnp.uint32(acc))))
        frame = tpt.render_sample(scene, cam, W, H, acc, PORT_SETTINGS)
        torch.testing.assert_close(
            got, frame[torch.tensor(y.astype(np.int64)),
                       torch.tensor(x.astype(np.int64))], rtol=0, atol=0)
        assert float(got.mean()) > 0.0


def test_render_rays_matches_jax(scenes):
    """Camera rays through seeded sub-pixel points with one pixel hash:
    the port's estimator on the JAX rays against JAX's, under the frame
    gate."""
    jscene, jcam, scene, _ = scenes
    uv = np.random.default_rng(6).uniform(0.05, 0.95, (96, 2))
    o, d = jax_rays(jcam, jnp.asarray(uv, jnp.float32))
    ref = jax.jit(lambda o, d: jpt.render_rays(jscene, o, d, 12345,
                                               jnp.uint32(1), SETTINGS))(o, d)
    got = tpt.render_rays(scene, torch.tensor(np.asarray(o)),
                          torch.tensor(np.asarray(d)), 12345, 1,
                          PORT_SETTINGS)
    assert got.shape == (96, 3)
    assert_statistical_gate(got.numpy(), np.asarray(ref))
    assert float(got.mean()) > 0.0


# -- plain, replay and remat ---------------------------------------------------------

@pytest.fixture(scope="module")
def cornell():
    return create_cornell_box(device="cpu")


def _cornell_loss_grad(scene, cam, settings, monkeypatch):
    """mean(render_sample) at 16² over material 1's tint and roughness →
    (loss, (d tint, d roughness), queries in the forward, in the
    backward)."""
    calls = []
    for name in ("intersect_scene", "intersect_scene_any"):
        real = getattr(tpt, name)
        monkeypatch.setattr(tpt, name, lambda *a, _real=real, **k: (
            calls.append(1), _real(*a, **k))[1])
    tint = scene.materials.tint[1].clone().requires_grad_()
    rough = scene.materials.roughness[1].clone().requires_grad_()
    rows = torch.arange(scene.materials.tint.shape[0])
    mats = scene.materials._replace(
        tint=torch.where((rows == 1)[:, None], tint, scene.materials.tint),
        roughness=torch.where(rows == 1, rough, scene.materials.roughness))
    img = tpt.render_sample(scene._replace(materials=mats), cam, 16, 16, 0,
                            settings)
    loss = img.mean()
    forward = len(calls)
    grads = torch.autograd.grad(loss, (tint, rough))
    return loss, grads, forward, len(calls) - forward


@pytest.mark.parametrize("variant", ["replay", "remat", "replay+remat"])
def test_replay_and_remat_match_plain_ad(cornell, monkeypatch, variant):
    """JAX's test_detached_replay_vjp_matches_plain_ad on the port: the
    loss bit for bit, the gradients within rtol 1e-5 (atol 1e-8),
    roughness's reparameterized path included. Plain traces 2 queries an
    iteration in the forward and none in the backward; replay traces none
    in its backward; remat traces again in its backward."""
    scene, cam = cornell
    base = tpt.settings_for_scene(scene, max_bounce_count=2,
                                  remat_bounces=False)
    settings = base._replace(remat_bounces="remat" in variant,
                             detached_replay_vjp="replay" in variant)
    iters = base.max_bounce_count + 1 + base.passthrough_slack
    v1, g1, fwd1, bwd1 = _cornell_loss_grad(scene, cam, base, monkeypatch)
    v2, g2, fwd2, bwd2 = _cornell_loss_grad(scene, cam, settings,
                                            monkeypatch)
    assert (fwd1, bwd1) == (2 * iters, 0)
    assert fwd2 == 2 * iters
    assert bwd2 == (2 * iters if variant == "remat" else 0)
    assert v1.item() == v2.item()
    for a, b in zip(g1, g2):
        assert float(a.abs().max()) > 0.0
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-8)
