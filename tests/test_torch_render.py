"""The PyTorch port's CornellBox slice against the JAX package, on the CPU.

Both render the very same scene arrays (the JAX scene carried across with
``render_scene_from_numpy``) at 32², 2 bounces. Single-sample frames are
compared under the statistical gate of tests/test_pallas_mesh.py:25-42
(≤ 3% of pixels off by more than 1e-3, means within 2%): float
reassociation between XLA and PyTorch can flip individual stochastic
decisions, while the RNG chains themselves are bit-exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bifrost3d_tpu.apps.scenes import create_cornell_box as jax_cornell_box
from bifrost3d_tpu.integrator import path_tracer as jpt

from bifrost3d_tpu_torch.apps.scenes import create_cornell_box
from bifrost3d_tpu_torch.integrator import path_tracer as tpt
from bifrost3d_tpu_torch.scene.camera import camera_from_numpy
from bifrost3d_tpu_torch.scene.render_scene import render_scene_from_numpy
from torch_parity import assert_statistical_gate, camera_arrays, scene_arrays

RES = 32
BOUNCES = 2
ENTRIES = ("render_sample", "render_sample_pooled")


@pytest.fixture(scope="module")
def jax_cornell():
    scene, cam = jax_cornell_box()
    settings = jpt.settings_for_scene(scene, max_bounce_count=BOUNCES)
    refs = {(name, acc): np.asarray(getattr(jpt, name)(
                scene, cam, RES, RES, jnp.uint32(acc), settings))
            for name in ENTRIES for acc in (0, 3)}
    return scene, cam, refs


@pytest.fixture(scope="module")
def carried(jax_cornell):
    scene, cam, _ = jax_cornell
    port_scene = render_scene_from_numpy(scene_arrays(scene), device="cpu")
    port_cam = camera_from_numpy(camera_arrays(cam), device="cpu")
    return port_scene, port_cam


def test_own_build_matches_jax_scene(jax_cornell, carried):
    jscene, jcam, _ = jax_cornell
    scene, cam = create_cornell_box(device="cpu")
    ref, _ = carried
    np.testing.assert_array_equal(scene.tri_normals_oct.numpy(),
                                  ref.tri_normals_oct.numpy())
    np.testing.assert_array_equal(scene.tri_material.numpy(),
                                  ref.tri_material.numpy())
    np.testing.assert_allclose(scene.tri_verts.numpy(), ref.tri_verts.numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(scene.tri_components.numpy(),
                               ref.tri_components.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(scene.scene_epsilon.numpy(),
                               ref.scene_epsilon.numpy(), rtol=1e-6)
    for field in ref.materials._fields:
        np.testing.assert_allclose(getattr(scene.materials, field).numpy(),
                                   getattr(ref.materials, field).numpy())
    for field in ref.lights._fields:
        np.testing.assert_allclose(getattr(scene.lights, field).numpy(),
                                   getattr(ref.lights, field).numpy())
    jarr = camera_arrays(jcam)
    np.testing.assert_allclose(cam.transform.translation.numpy(),
                               jarr["translation"], atol=1e-7)
    np.testing.assert_allclose(cam.transform.rotation.numpy(),
                               jarr["rotation"], atol=1e-6)
    np.testing.assert_allclose(cam.inverse_projection.numpy(),
                               jarr["inverse_projection"], rtol=1e-6)


@pytest.mark.parametrize("accumulation", [0, 3])
@pytest.mark.parametrize("entry", ENTRIES)
def test_cornell_matches_jax(jax_cornell, carried, entry, accumulation):
    _, _, refs = jax_cornell
    scene, cam = carried
    settings = tpt.settings_for_scene(scene, max_bounce_count=BOUNCES)
    img = getattr(tpt, entry)(scene, cam, RES, RES, accumulation, settings)
    assert img.shape == (RES, RES, 3)
    assert_statistical_gate(img.numpy(), refs[entry, accumulation])
    assert float(img.mean()) > 0.05   # actually lit


def test_own_scene_renders_like_jax(jax_cornell):
    _, _, refs = jax_cornell
    scene, cam = create_cornell_box(device="cpu")
    settings = tpt.settings_for_scene(scene, max_bounce_count=BOUNCES)
    img = tpt.render_sample_pooled(scene, cam, RES, RES, 0, settings)
    assert_statistical_gate(img.numpy(), refs["render_sample_pooled", 0])


def test_pooled_small_pool_matches_full_pool(carried):
    """Refilling a pool much smaller than the frame renders the same
    pixels (each pixel's path depends only on its own RNG chain)."""
    scene, cam = carried
    settings = tpt.settings_for_scene(scene, max_bounce_count=BOUNCES)
    full, rays_full, it_full = tpt.render_pixels_pooled(
        scene, cam, 16, 16, 1, settings, with_iters=True)
    small, rays_small, it_small = tpt.render_pixels_pooled(
        scene, cam, 16, 16, 1, settings, pool_size=64, with_iters=True)
    np.testing.assert_allclose(small.numpy(), full.numpy(), rtol=1e-6,
                               atol=1e-7)
    assert int(rays_small) == int(rays_full) > 0
    assert it_small > it_full


def test_counted_ray_count_matches_jax(jax_cornell, carried):
    jscene, jcam, _ = jax_cornell
    scene, cam = carried
    jset = jpt.settings_for_scene(jscene, max_bounce_count=BOUNCES)
    _, jrays = jpt.render_sample_pooled_counted(jscene, jcam, 16, 16,
                                                jnp.uint32(0), jset)
    settings = tpt.settings_for_scene(scene, max_bounce_count=BOUNCES)
    _, rays = tpt.render_sample_pooled_counted(scene, cam, 16, 16, 0, settings)
    assert abs(int(rays) - int(jrays)) <= 0.02 * int(jrays)


@pytest.mark.parametrize("high_precision", [False, True])
def test_render_progressive(carried, high_precision):
    scene, cam = carried
    settings = tpt.settings_for_scene(scene, max_bounce_count=1)
    img = tpt.render_progressive(scene, cam, 16, 16, 3, settings,
                                 high_precision=high_precision)
    frames = [tpt.render_sample_fast(scene, cam, 16, 16, n, settings)
              for n in range(3)]
    np.testing.assert_allclose(img.numpy(), torch.stack(frames).mean(0).numpy(),
                               rtol=1e-5, atol=1e-6)
    assert torch.isfinite(img).all() and float(img.mean()) > 0.0


def test_explain_render_path(carried):
    scene, _ = carried
    assert tpt.explain_render_path(scene) == \
        "wavefront: device is cpu, not cuda"


@pytest.mark.parametrize("override, feature", [
    (dict(path_regularization_scale=1.0), "path regularization"),
    (dict(coverage_aware_shadows=True), None),
    (dict(trilinear_textures=True), "trilinear"),
])
def test_unported_settings_raise(jax_cornell, carried, override, feature):
    """Every setting is ported (regularization and trilinear textures
    raised before): on the opaque, untextured Cornell the march of closest
    hits gives the binary shadow ray's frame and the trilinear hint
    changes nothing; path regularization renders a lit frame, held
    against JAX's in test_torch_regularization.py."""
    scene, cam = carried
    settings = tpt.settings_for_scene(scene, **override)
    img = tpt.render_sample_pooled(scene, cam, 8, 8, 0, settings)
    ref = tpt.render_sample_pooled(scene, cam, 8, 8, 0,
                                   tpt.settings_for_scene(scene))
    assert torch.isfinite(img).all() and float(img.mean()) > 0.0
    if feature == "path regularization":
        jscene, jcam, _ = jax_cornell
        jref = jpt.render_sample_pooled(
            jscene, jcam, 8, 8, jnp.uint32(0),
            jpt.settings_for_scene(jscene, **override))
        assert_statistical_gate(img.numpy(), np.asarray(jref))
        return
    np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_unported_shading_models_raise(jax_cornell):
    """Every shading model is ported: a Transmissive material in Cornell no
    longer raises; it renders, on the wavefront, which names it as the
    megakernel's reason (its frame is held against JAX's in
    test_torch_faults.py and test_torch_transmissive_frames.py)."""
    jscene, _, _ = jax_cornell
    arrays = scene_arrays(jscene)
    arrays["materials"] = dict(arrays["materials"])
    models = arrays["materials"]["shading_model"].copy()
    models[0] = 2
    arrays["materials"]["shading_model"] = models
    scene = render_scene_from_numpy(arrays, device="cpu")
    cam = create_cornell_box(device="cpu")[1]
    img = tpt.render_sample(scene, cam, 8, 8, 0, tpt.settings_for_scene(scene))
    assert torch.isfinite(img).all() and float(img.mean()) > 0.0
    assert "Transmissive shading model" in tpt.explain_render_path(scene)
