"""The preview renderer (preview/) against the JAX package, on the CPU.

``ssao``, ``bilateral_blur``, ``_convolve_level`` and ``sample_ibl`` are
deterministic and gated with ``assert_f64_anchored`` (SSAO on a G-buffer
of two planes meeting at a crease, seeded; the IBL on a seeded 32 × 16
latlong map and the 64 PMJ02 samples ``convolve_environment`` draws).
``render_preview`` traces, so its frames are held pixel by pixel: at 32²
on CornellBox and on tests/test_preview.py's half-coverage pane (4
transparent layers), SSAO off, at most 3% of the pixels off by more than
1e-3 (measured 0.7%: pixels where one package's trace hits a triangle
edge and the other's misses) and the means within 0.5%. With SSAO on,
CornellBox's budget is 6% (measured 4.2%): the AO pass reads those edge
pixels' positions and its 9-tap cross blur spreads each over its row and
column.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifrost3d_tpu.apps.scenes import create_cornell_box as jax_cornell_box
from bifrost3d_tpu.geometry.creation import make_plane
from bifrost3d_tpu.lights.types import LIGHT_SPHERE, LightArray
from bifrost3d_tpu.preview import ibl as jibl
from bifrost3d_tpu.preview import renderer as jrenderer
from bifrost3d_tpu.preview.ssao import bilateral_blur as jax_blur
from bifrost3d_tpu.preview.ssao import ssao as jax_ssao
from bifrost3d_tpu.scene.camera import perspective_camera
from bifrost3d_tpu.scene.materials import MaterialArray
from bifrost3d_tpu.scene.render_scene import build_render_scene
from bifrost3d_tpu.sampling.pmj import pmj02_bn_samples

from bifrost3d_tpu_torch.preview import ibl as tibl
from bifrost3d_tpu_torch.preview import renderer as trenderer
from bifrost3d_tpu_torch.preview.ssao import bilateral_blur, ssao
from bifrost3d_tpu_torch.scene.camera import camera_from_numpy
from bifrost3d_tpu_torch.scene.render_scene import render_scene_from_numpy
from torch_parity import (
    assert_f64_anchored,
    assert_statistical_gate,
    camera_arrays,
    scene_arrays,
)

RES = 32


def _gbuffer(seed, h=24, w=32):
    """View positions and normals of a floor meeting a back wall, with a
    seeded jitter, and a mask with a hole."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    x = (xs - w / 2) / (w / 2)
    floor = ys > h / 2
    z = np.where(floor, 1.0 + (h - ys) / h * 3.0, 2.5)
    y = np.where(floor, -0.5, 0.5 - ys / h)
    pos = np.stack([x * z * 0.5, y, z], -1) + rng.normal(0, 1e-3, (h, w, 3))
    normal = np.where(floor[..., None], [0.0, 1.0, 0.0], [0.0, 0.0, -1.0])
    normal = normal + rng.normal(0, 0.05, (h, w, 3))
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    mask = np.ones((h, w), bool)
    mask[2:5, 3:9] = False
    return pos.astype(np.float32), normal.astype(np.float32), mask


def test_ssao_matches_jax():
    pos, normal, mask = _gbuffer(0)
    assert_f64_anchored(ssao, jax_ssao, pos, normal, mask)
    assert_f64_anchored(
        lambda p, n, m: ssao(p, n, m, 0.5, 0.02, 1.5, 12),
        lambda p, n, m: jax_ssao(p, n, m, 0.5, 0.02, 1.5, 12),
        pos, normal, mask)


def test_bilateral_blur_matches_jax():
    rng = np.random.default_rng(1)
    ao = rng.random((24, 32)).astype(np.float32)
    depth = (1.0 + rng.random((24, 32)) * 0.3).astype(np.float32)
    assert_f64_anchored(bilateral_blur, jax_blur, ao, depth)


def _sky(h=16, w=32, seed=2):
    rng = np.random.default_rng(seed)
    env = np.exp(rng.normal(0.0, 1.0, (h, w, 3))).astype(np.float32)
    env[3, 7] = 50.0
    return env


@pytest.mark.parametrize("roughness", [0.25, 0.6, 1.0])
def test_convolve_level_matches_jax(roughness):
    u2 = np.asarray(pmj02_bn_samples(64), np.float32)
    assert_f64_anchored(
        lambda env, u: tibl._convolve_level(env, roughness, u),
        lambda env, u: jibl._convolve_level(env, roughness, u),
        _sky(), u2)


def test_convolve_environment_levels():
    env = _sky(64, 128)
    mips = tibl.convolve_environment(torch.tensor(env), samples=16)
    ref = jibl.convolve_environment(jnp.asarray(env), samples=16)
    assert [r for r, _ in mips] == [r for r, _ in ref]
    assert [tuple(m.shape) for _, m in mips] == [m.shape for _, m in ref]
    for (_, got), (_, want) in zip(mips, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=1e-6)


def test_sample_ibl_matches_jax():
    rng = np.random.default_rng(3)
    levels = [(0.0, _sky(16, 32, 4)), (0.3, _sky(8, 16, 5)),
              (0.7, _sky(8, 16, 6)), (1.0, _sky(8, 16, 7))]
    direction = rng.normal(size=(4096, 3))
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    roughness = rng.uniform(-0.2, 1.2, 4096)
    roughness[:5] = (0.0, 0.3, 0.7, 1.0, 0.5)

    def port(d, r, *imgs):
        return tibl.sample_ibl(list(zip([l for l, _ in levels], imgs)), d, r)

    def jax_fn(d, r, *imgs):
        return jibl.sample_ibl(list(zip([l for l, _ in levels], imgs)), d, r)

    assert_f64_anchored(port, jax_fn, direction.astype(np.float32),
                        roughness.astype(np.float32),
                        *[img for _, img in levels])


def _pane_scene(pane_coverage):
    """tests/test_preview.py's wall and pane, the JAX package's scene."""
    mats = MaterialArray.build([
        dict(tint=(0.9, 0.1, 0.1)),
        dict(tint=(0.1, 0.1, 0.9), coverage=pane_coverage)])
    rot = np.asarray([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0]], np.float32)
    instances = [
        (make_plane(size=4.0), 0, rot + np.asarray(
            [[0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 2.0]], np.float32)),
        (make_plane(size=4.0), 1, rot)]
    lights = LightArray.build([
        {"kind": LIGHT_SPHERE, "position": (0.0, 0.0, -3.0), "radius": 0.1,
         "power": (60.0,) * 3}])
    scene = build_render_scene(instances, mats, lights)
    cam = perspective_camera(eye=(0, 0, -4.0), target=(0, 0, 0),
                             fov_radians=np.pi / 4, aspect=1.0)
    return scene, cam


CASES = {"cornell": (jax_cornell_box, False, 0.03),
         "cornell_ssao": (jax_cornell_box, True, 0.06),
         "pane": (lambda: _pane_scene(0.5), False, 0.03)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_preview_matches_jax(case):
    make, enable_ssao, budget = CASES[case]
    jscene, jcam = make()
    ref = np.asarray(jrenderer.render_preview(jscene, jcam, RES, RES,
                                              enable_ssao=enable_ssao))
    scene = render_scene_from_numpy(scene_arrays(jscene), device="cpu")
    cam = camera_from_numpy(camera_arrays(jcam), device="cpu")
    img = trenderer.render_preview(scene, cam, RES, RES,
                                   enable_ssao=enable_ssao).numpy()
    assert img.shape == (RES, RES, 3)
    assert_statistical_gate(img, ref, flip_budget=budget, mean_budget=0.005)
    if case == "pane":
        # 4 layers: the blend of the pane over the wall.
        opaque = trenderer.render_preview(
            render_scene_from_numpy(scene_arrays(_pane_scene(1.0)[0]),
                                    device="cpu"), cam, RES, RES,
            enable_ssao=False).numpy()
        clear = trenderer.render_preview(
            render_scene_from_numpy(scene_arrays(_pane_scene(0.0)[0]),
                                    device="cpu"), cam, RES, RES,
            enable_ssao=False).numpy()
        np.testing.assert_allclose(img, 0.5 * opaque + 0.5 * clear,
                                   rtol=1e-4, atol=1e-5)


def test_preview_backend():
    jscene, jcam = jax_cornell_box()
    scene = render_scene_from_numpy(scene_arrays(jscene), device="cpu")
    cam = camera_from_numpy(camera_arrays(jcam), device="cpu")
    backend = trenderer.PreviewBackend(scene, cam, 8, 8)
    a, b = backend.render(), backend.render()
    assert backend.accumulations == 2
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a, trenderer.render_preview(scene, cam, 8, 8),
                               rtol=0, atol=0)
    backend.reset()
    assert backend.accumulations == 0
