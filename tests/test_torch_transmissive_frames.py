"""Glass and Test, the two viewer scenes with the Transmissive model,
rendered by the port's wavefront against JAX's on the CPU: the JAX scene
carried across (``render_scene_from_numpy``), 16 × 16, 4 bounces, two
accumulations each, under the statistical gate of
tests/test_pallas_mesh.py:25-42 (≤ 3% of pixels off by more than 1e-3,
means within 2%). Glass (roughness 0.0 and 0.15) matches within 3e-4 on
every pixel.

Test's glass sphere has roughness 0.05 (alpha 0.0025): its lobe is sharp
enough that float32 rounding flips paths through it, on the sphere (20 of
the 256 pixels) and where it is seen in other surfaces. Over accumulations
0–7 JAX's own jitted and eager frames differ by more than 1e-3 on 4.7–7.0%
of the pixels a frame, the port's from JAX's jitted ones on 5.9–7.0%, from
JAX's eager ones on 3.9–6.3%. One frame of Test is therefore held at a 10%
pixel budget, and the sphere by the average of 8 frames, where the flips
average out: there every pixel of JAX's own two frames and of the port's
against either is within 3.4% of its value, at most 3 pixels off by more
than 2%, and the sphere's mean within 0.09% (``python3
tests/torch_parity.py`` prints these spreads).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifrost3d_tpu.apps import scenes as jax_scenes
from bifrost3d_tpu.integrator import path_tracer as jpt

from bifrost3d_tpu_torch.geometry.traverse import intersect_scene
from bifrost3d_tpu_torch.integrator import path_tracer as tpt
from bifrost3d_tpu_torch.scene.camera import camera_from_numpy
from bifrost3d_tpu_torch.scene.render_scene import render_scene_from_numpy
from torch_parity import assert_statistical_gate, camera_arrays, scene_arrays

RES = 16
BOUNCES = 4
FLIP_BUDGET = {"Glass": 0.03, "Test": 0.10}
# The average of Test's accumulations 0 .. AVERAGED - 1: at most 3% of the
# pixels more than 2% off JAX's, the glass sphere's mean within 1% and the
# frame's within 0.5%.
AVERAGED = 8
GLASS_MATERIAL = 3


@pytest.mark.parametrize("accumulation", [0, 1])
@pytest.mark.parametrize("name", ["Glass", "Test"])
def test_transmissive_scene_matches_jax(name, accumulation):
    jscene, jcam = jax_scenes.SCENES[name]()
    settings = jpt.settings_for_scene(jscene, max_bounce_count=BOUNCES)
    ref = np.asarray(jpt.render_sample(jscene, jcam, RES, RES,
                                       jnp.uint32(accumulation), settings))
    scene = render_scene_from_numpy(scene_arrays(jscene), device="cpu")
    cam = camera_from_numpy(camera_arrays(jcam), device="cpu")
    assert 2 in scene.shading_models
    img = tpt.render_sample(scene, cam, RES, RES, accumulation,
                            tpt.settings_for_scene(
                                scene, max_bounce_count=BOUNCES))
    assert float(img.mean()) > 0.0
    assert_statistical_gate(img.numpy(), ref, flip_budget=FLIP_BUDGET[name])


def _glass_pixels(scene, cam, accumulations):
    """Pixels whose camera ray, at any of the accumulations' jitters, first
    hits Test's glass sphere."""
    y, x = torch.meshgrid(torch.arange(RES), torch.arange(RES),
                          indexing="ij")
    mask = torch.zeros(RES * RES, dtype=torch.bool)
    for acc in accumulations:
        lanes, _ = tpt._pixel_lane_state(cam, x, y, RES, acc, RES)
        hit = tpt._scene_query(intersect_scene, scene, lanes.origin,
                               lanes.direction, 1e-4)
        mat = scene.tri_material[hit.prim.clamp_min(0).long()]
        mask |= (hit.prim >= 0) & (mat == GLASS_MATERIAL)
    return mask.reshape(RES, RES).numpy()


def test_test_scene_average_matches_jax():
    """Test's rough glass sphere, held where the flips of single frames
    average out: the mean of AVERAGED frames of the port against JAX's."""
    jscene, jcam = jax_scenes.SCENES["Test"]()
    settings = jpt.settings_for_scene(jscene, max_bounce_count=BOUNCES)
    scene = render_scene_from_numpy(scene_arrays(jscene), device="cpu")
    cam = camera_from_numpy(camera_arrays(jcam), device="cpu")
    tset = tpt.settings_for_scene(scene, max_bounce_count=BOUNCES)
    accs = range(AVERAGED)
    ref = np.mean([np.asarray(jpt.render_sample(
        jscene, jcam, RES, RES, jnp.uint32(acc), settings)) for acc in accs],
        axis=0)
    img = np.mean([tpt.render_sample(scene, cam, RES, RES, acc,
                                     tset).numpy() for acc in accs], axis=0)
    assert np.isfinite(img).all()
    glass = _glass_pixels(scene, cam, accs)
    assert 0.05 < glass.mean() < 0.10, glass.mean()
    off = np.abs(img - ref).max(axis=-1) / np.maximum(ref.max(axis=-1), 1e-3)
    assert (off > 0.02).mean() <= 0.03, np.sort(off.ravel())[-8:]
    np.testing.assert_allclose(img[glass].mean(), ref[glass].mean(),
                               rtol=0.01)
    np.testing.assert_allclose(img.mean(), ref.mean(), rtol=0.005)
