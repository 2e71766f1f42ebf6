"""``optimize_materials`` of the port against the JAX package's, on the
CPU: tests/test_diff.py's test_recover_tint (its scene, settings and gate)
on the port, and the first three Adam steps on both sides.

Tie semantics: JAX splits a min/max/clip gradient half and half at a tie,
torch's clamp passes all of it, so at a roughness exactly on a clamp bound
(1.0 or 0.02) the two gradients differ. This run starts at roughness 0.6
and lr 0.1 moves it at most 0.3 in three steps, so the compared steps meet
no tie.
"""

import numpy as np
import pytest
import torch

from bifrost3d_tpu.diff import optimize_materials as jax_optimize_materials
from bifrost3d_tpu.integrator import path_tracer as jpt

from bifrost3d_tpu_torch.diff import optimize_materials
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
from torch_parity import camera_arrays, elementary_rounded_once, scene_arrays


@pytest.fixture(scope="module")
def recovery():
    """test_recover_tint's run on both sides: JAX's target render of tint
    (0.8, 0.2, 0.5) at 1 bounce (handed to the port as numpy), start
    (0.4, 0.6, 0.3), lr 0.1, fixed samples. JAX runs three steps and one;
    its step is the very computation of test_recover_tint, so JAX's
    persistent compilation cache compiles it once for both tests. The port
    runs three steps and the sixteen of the gate."""
    settings = SETTINGS._replace(max_bounce_count=1)
    cam = make_jax_camera()
    target = jpt.render_sample(make_jax_scene(tint=(0.8, 0.2, 0.5)), cam, W,
                               H, 0, settings)
    start = make_jax_scene(tint=(0.4, 0.6, 0.3))
    jax_runs = {steps: jax_optimize_materials(
        start, cam, target, W, H, steps=steps, learning_rate=0.1,
        vary_samples=False, settings=settings) for steps in (3, 1)}
    port_start = render_scene_from_numpy(scene_arrays(start), device="cpu")
    port_cam = camera_from_numpy(camera_arrays(cam), device="cpu")
    def port_run(steps):
        return optimize_materials(
            port_start, port_cam, torch.tensor(np.asarray(target)), W, H,
            steps=steps, learning_rate=0.1, vary_samples=False,
            settings=tpt.RenderSettings(*settings))
    port_runs = {steps: port_run(steps) for steps in (3, 16)}
    with elementary_rounded_once():
        port_runs["3, rounded once"] = port_run(3)
    return start, jax_runs, port_runs


def test_optimize_materials_recovers_tint(recovery):
    """test_recover_tint's gate: the loss falls below a quarter of its
    start, the tint within 0.15 of the target."""
    result = recovery[2][16]
    assert result.losses[-1] < 0.25 * result.losses[0], result.losses
    np.testing.assert_allclose(result.scene.materials.tint[0].numpy(),
                               [0.8, 0.2, 0.5], atol=0.15)
    assert not result.scene.materials.tint.requires_grad


# The host run's atol per field where it is not 1e-5: the roughness after
# three steps moves by 1.68e-5 between the host's float32 elementary
# functions and the same run with them rounded once from float64 (torch's
# float32 sqrt on an AVX-512 CPU is faithful, not correctly rounded), where
# the rounded-once run is 1.4e-6 from JAX's.
HOST_ATOL = {"roughness": 5e-5}


def test_optimize_materials_first_steps_match_jax(recovery):
    """Three steps on both sides: the losses within rtol 1e-4 of JAX's.
    Adam's update divides by √v, so a step is ±lr wherever |g| is far above
    the float32 noise and anything in [-lr, lr] where it is not: the
    parameters after three steps are held (atol 1e-5) only where JAX's
    starting |g| exceeds 1e-6, read from JAX's own first step: it moves a
    parameter by lr·|g|/(|g| + 1e-8), at least 0.99·lr exactly when
    |g| >= 9.9e-7 (here all four: tint's three channels and the
    roughness). The run with elementary functions rounded once is held at
    atol 1e-5, the host run at ``HOST_ATOL``."""
    start, jax_runs, port_runs = recovery
    result = port_runs[3]
    np.testing.assert_allclose(result.losses, jax_runs[3].losses, rtol=1e-4)
    np.testing.assert_allclose(port_runs[16].losses[:3], result.losses,
                               rtol=0)
    checked = 0
    for field in ("tint", "roughness"):
        first = np.abs(np.asarray(getattr(jax_runs[1].scene.materials, field))
                       - np.asarray(getattr(start.materials, field)))
        strong = first >= 0.99 * 0.1
        want = np.asarray(getattr(jax_runs[3].scene.materials, field))[strong]
        checked += int(strong.sum())
        for run, atol in ((port_runs["3, rounded once"], 1e-5),
                          (result, HOST_ATOL.get(field, 1e-5))):
            got = getattr(run.scene.materials, field).numpy()[strong]
            np.testing.assert_allclose(got, want, atol=atol, err_msg=field)
    assert checked >= 3
