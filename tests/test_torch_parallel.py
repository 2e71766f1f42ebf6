"""The port's sharded renders (``bifrost3d_tpu_torch/parallel``) against the
JAX package's on the CPU, and against the port's own unsharded renders.

The JAX side runs on conftest's 8 CPU devices; the port's mesh is
``[cpu] * 8`` (or 3, whose row split pads and crops), so both split the
rows alike.

- ``make_sharded_render`` at 16², 2 bounces, with tests/test_parallel.py's
  settings: against JAX's at rtol 1e-5 and atol 1e-5 (JAX's own
  multi-host gate, tests/test_distributed.py; JAX's atol alone fails on
  one pixel of 256, 1.24e-5 off on a radiance above 1), and bit for bit
  against the port's unsharded pooled frame;
- ``render_pixels_pooled`` over pixel ranges: the ranges of a frame put
  together are the frame, bit for bit, at any pool size, and the default
  range is the frame;
- ``make_sharded_smallpt`` at 32 × 24 and 16 × 13: bit for bit against the
  port's unsharded SmallPT frame, and against JAX's sharded frame under
  the port's SmallPT gate (``assert_smallpt_gate``: JAX's 1e-6 holds on
  99% of the pixels; 1–1.5% take another path, up to 9.0 off, where float
  rounding flips a grazing hit or a roulette draw).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifrost3d_tpu.apps.scenes import create_cornell_box as jax_cornell
from bifrost3d_tpu.integrator import path_tracer as jpt
from bifrost3d_tpu.parallel import make_sharded_render as jax_sharded_render
from bifrost3d_tpu.parallel import make_sharded_smallpt as jax_sharded_smallpt
from bifrost3d_tpu.parallel import render_mesh as jax_render_mesh
from bifrost3d_tpu.scene import smallpt_scene as jax_smallpt_scene

from bifrost3d_tpu_torch.integrator import path_tracer as tpt
from bifrost3d_tpu_torch.integrator.smallpt import (
    render_smallpt,
    render_smallpt_accumulation,
)
from bifrost3d_tpu_torch.parallel import (
    make_sharded_render,
    make_sharded_smallpt,
    pad_to_multiple,
    render_mesh,
    render_smallpt_sharded,
    replicated_sharding,
    tile_sharding,
)
from bifrost3d_tpu_torch.scene.camera import camera_from_numpy
from bifrost3d_tpu_torch.scene.render_scene import render_scene_from_numpy
from bifrost3d_tpu_torch.scene.spheres import sphere_scene_from_numpy
from torch_parity import (
    assert_smallpt_gate,
    camera_arrays,
    scene_arrays,
    sphere_scene_arrays,
)

CPU = torch.device("cpu")
CPU8 = [CPU] * 8
RES = 16


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
    return jax_render_mesh(jax.devices()[:8])


@pytest.fixture(scope="module")
def cornell():
    """CornellBox with tests/test_parallel.py's settings, both sides."""
    scene, cam = jax_cornell()
    settings = jpt.settings_for_scene(scene, max_bounce_count=2)._replace(
        next_event_sample_count=1, passthrough_slack=0)
    return (scene, cam, settings,
            render_scene_from_numpy(scene_arrays(scene), device="cpu"),
            camera_from_numpy(camera_arrays(cam), device="cpu"),
            tpt.RenderSettings(*settings))


def test_sharded_render_matches_jax(mesh8, cornell):
    scene, cam, settings, p_scene, p_cam, p_settings = cornell
    ref = np.asarray(jax_sharded_render(mesh8, RES, RES, settings)(
        scene, cam, 1))
    got = make_sharded_render(CPU8, RES, RES, p_settings)(p_scene, p_cam, 1)
    assert got.shape == (RES, RES, 3) and got.device == CPU
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shards", [8, 3])
def test_sharded_render_equals_unsharded(cornell, shards):
    *_, p_scene, p_cam, p_settings = cornell
    got = make_sharded_render([CPU] * shards, RES, RES, p_settings,
                              pool_size=24)(p_scene, p_cam, 2)
    full, _ = tpt.render_pixels_pooled(p_scene, p_cam, RES, RES, 2,
                                       p_settings)
    assert torch.equal(got, full.reshape(RES, RES, 3))


@pytest.mark.parametrize("pool_size", [65536, 100, 37])
def test_pooled_ranges_make_the_frame(cornell, pool_size):
    """Two halves, and three uneven ranges, of a frame are the frame bit
    for bit; the default range is the whole frame."""
    *_, p_scene, p_cam, p_settings = cornell
    n = RES * RES
    full, rays = tpt.render_pixels_pooled(p_scene, p_cam, RES, RES, 1,
                                          p_settings, pool_size)
    explicit, rays_explicit = tpt.render_pixels_pooled(
        p_scene, p_cam, RES, RES, 1, p_settings, pool_size, pixel_start=0,
        n_pixels=n)
    assert torch.equal(explicit, full) and int(rays_explicit) == int(rays)
    for bounds in ((0, n // 2, n), (0, 37, 200, n)):
        parts = [tpt.render_pixels_pooled(p_scene, p_cam, RES, RES, 1,
                                          p_settings, pool_size,
                                          pixel_start=lo, n_pixels=hi - lo)[0]
                 for lo, hi in zip(bounds, bounds[1:])]
        assert torch.equal(torch.cat(parts), full)


@pytest.mark.parametrize("width, height, accumulation",
                         [(32, 24, 1), (16, 13, 2)])
def test_sharded_smallpt(mesh8, width, height, accumulation):
    scene = jax_smallpt_scene()
    ref = np.asarray(jax_sharded_smallpt(mesh8, width, height)(
        scene, jnp.uint32(accumulation)))
    p_scene = sphere_scene_from_numpy(sphere_scene_arrays(scene),
                                      device="cpu")
    got = make_sharded_smallpt(CPU8, width, height)(p_scene, accumulation)
    assert got.shape == (height, width, 3)
    assert torch.equal(got, render_smallpt_accumulation(p_scene, width,
                                                        height, accumulation))
    assert_smallpt_gate(got.numpy(), ref, mean_budget=None)


def test_render_smallpt_sharded_is_the_progressive_render():
    scene = sphere_scene_from_numpy(sphere_scene_arrays(jax_smallpt_scene()),
                                    device="cpu")
    got = render_smallpt_sharded(scene, 16, 12, 3, mesh=[CPU] * 4)
    assert torch.equal(got, render_smallpt(scene, 16, 12, 3))


def test_mesh_and_shardings():
    assert render_mesh(["cpu", "cpu"]) == [CPU, CPU]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            render_mesh()
    assert pad_to_multiple(13, 8) == 16 and pad_to_multiple(16, 8) == 16
    x = torch.arange(24.0).reshape(6, 4)
    blocks = tile_sharding([CPU] * 3).place(x)
    assert [b.shape for b in blocks] == [(2, 4)] * 3
    assert torch.equal(torch.cat(blocks), x)
    assert all(torch.equal(b, x) for b in replicated_sharding([CPU] * 2)
               .place(x))
    with pytest.raises(ValueError, match="does not divide"):
        tile_sharding([CPU] * 4).place(x)
