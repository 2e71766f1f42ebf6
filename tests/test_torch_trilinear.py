"""Trilinear textures (the ray footprint and the mip blend) against the
JAX package, on the CPU.

``sample_texture(..., footprint_uv, trilinear=True)`` on the 4 × 4 and
256² checker banks of tests/test_textures.py, and ``_camera_pixel_angle``,
are deterministic and gated with ``assert_f64_anchored``. The ray
footprint lives inside the wavefront step (texel density × hit distance
× pixel angle / incidence spread), so it is held through the frame that
reads it: tests/test_textures.py's distant checkered floor (a 200-unit
plane, a directional light, a 256² trilinear checker) at 32², no bounce,
under the statistical gate of tests/test_pallas_mesh.py:25-42 (≤ 3% of
pixels off by more than 1e-3, means within 2%), where a wrong level of
detail changes the far floor's grey. The port's own frames keep that
test's aliasing check: within-row spread of level 0 > 2 × trilinear's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifrost3d_tpu.geometry import make_plane
from bifrost3d_tpu.integrator import path_tracer as jpt
from bifrost3d_tpu.io import texture as jtex
from bifrost3d_tpu.lights.types import LIGHT_DIRECTIONAL, LightArray
from bifrost3d_tpu.scene.camera import perspective_camera
from bifrost3d_tpu.scene.materials import MaterialArray
from bifrost3d_tpu.scene.render_scene import build_render_scene

from bifrost3d_tpu_torch.integrator import path_tracer as tpt
from bifrost3d_tpu_torch.io import texture as ttex
from bifrost3d_tpu_torch.scene.camera import camera_from_numpy
from bifrost3d_tpu_torch.scene.render_scene import render_scene_from_numpy
from torch_parity import (
    assert_f64_anchored,
    assert_statistical_gate,
    camera_arrays,
    scene_arrays,
)

RES = 32


def _checker(n):
    c = np.indices((n, n)).sum(axis=0) % 2
    return np.stack([c, c, c], axis=-1).astype(np.float32)


def _banks(n, wrap):
    textures = [dict(image=_checker(n), filter=jtex.FILTER_TRILINEAR,
                     wrap_u=wrap, wrap_v=wrap),
                dict(image=_checker(n) * 0.5 + 0.25,
                     filter=jtex.FILTER_LINEAR, wrap_u=wrap, wrap_v=wrap)]
    return (jtex.TextureBank.build(textures),
            ttex.TextureBank.build(textures, device="cpu"))


@pytest.mark.parametrize("wrap", [jtex.WRAP_REPEAT, jtex.WRAP_CLAMP],
                         ids=["repeat", "clamp"])
@pytest.mark.parametrize("n", [4, 256])
def test_trilinear_sample_texture_matches_jax(n, wrap):
    """Footprints from none (level 0) through every level to far past the
    chain's end, on the trilinear texture and on a bilinear one (which
    stays on level 0), and the default for id -1."""
    jbank, tbank = _banks(n, wrap)
    rng = np.random.default_rng(n + wrap)
    m = 4096
    uv = rng.uniform(-1.5, 2.5, size=(m, 2)).astype(np.float32)
    footprint = np.exp2(rng.uniform(-2.0, 2.0, m) - np.log2(n)
                        + rng.integers(0, 10, m)).astype(np.float32) / 8.0
    footprint[:8] = (0.0, 1.0 / n, 2.0 / n, 0.5, 1.0, 4.0, 1e-9, 1e3)
    ids = rng.integers(-1, 2, m).astype(np.int32)

    def port(uv, fp, ids):
        return ttex.sample_texture(tbank, ids, uv, footprint_uv=fp,
                                   trilinear=True)

    def jax_fn(uv, fp, ids):
        return jtex.sample_texture(jbank, ids, uv, footprint_uv=fp,
                                   trilinear=True)

    assert_f64_anchored(port, jax_fn, uv, footprint, ids)


def test_trilinear_off_without_footprint_is_level0():
    """``trilinear=True`` without a footprint reads level 0, as JAX's."""
    _, tbank = _banks(8, jtex.WRAP_REPEAT)
    uv = torch.rand(64, 2)
    ids = torch.zeros(64, dtype=torch.int32)
    torch.testing.assert_close(
        ttex.sample_texture(tbank, ids, uv, trilinear=True),
        ttex.sample_texture(tbank, ids, uv), rtol=0, atol=0)


def test_camera_pixel_angle_matches_jax():
    cam = perspective_camera(eye=(0, 1.0, 0), target=(0, 0.0, 30.0))
    port_cam = camera_from_numpy(camera_arrays(cam), device="cpu")

    def port(proj):
        return tpt._camera_pixel_angle(port_cam._replace(projection=proj), 48)

    def jax_fn(proj):
        return jpt._camera_pixel_angle(cam._replace(projection=proj), 48)

    proj = np.asarray(cam.projection, np.float32)
    assert_f64_anchored(port, jax_fn, proj)


@pytest.fixture(scope="module")
def distant_floor():
    bank = jtex.TextureBank.build([dict(image=_checker(256),
                                        filter=jtex.FILTER_TRILINEAR)])
    mats = MaterialArray.build([dict(tint=(1, 1, 1), roughness=1.0,
                                     tint_roughness_texture=0)])
    lights = LightArray.build([
        {"kind": LIGHT_DIRECTIONAL, "direction": (0, -1, 0.2),
         "radiance": (3.0, 3.0, 3.0)}])
    scene = build_render_scene([(make_plane(size=200.0), 0, None)], mats,
                               lights, textures=bank)
    cam = perspective_camera(eye=(0, 1.0, 0), target=(0, 0.0, 30.0))
    settings = jpt.settings_for_scene(scene, max_bounce_count=0,
                                      next_event_sample_count=1)
    assert settings.trilinear_textures
    ref = np.asarray(jpt.render_sample(scene, cam, RES, RES, jnp.uint32(0),
                                       settings))
    port_scene = render_scene_from_numpy(scene_arrays(scene), device="cpu")
    port_cam = camera_from_numpy(camera_arrays(cam), device="cpu")
    return port_scene, port_cam, ref


def test_distant_floor_frame_matches_jax(distant_floor):
    scene, cam, ref = distant_floor
    settings = tpt.settings_for_scene(scene, max_bounce_count=0,
                                      next_event_sample_count=1)
    assert settings.trilinear_textures
    img = tpt.render_sample(scene, cam, RES, RES, 0, settings).numpy()
    assert_statistical_gate(img, ref)
    pooled = tpt.render_sample_pooled(scene, cam, RES, RES, 0, settings)
    assert_statistical_gate(pooled.numpy(), ref)
    # Level 0 is another frame: the gate sees the mip level.
    level0 = tpt.render_sample(scene, cam, RES, RES, 0, settings._replace(
        trilinear_textures=False)).numpy()
    assert (np.abs(level0 - ref).max(-1) > 1e-3).mean() > 0.03


def test_trilinear_reduces_distant_aliasing(distant_floor):
    """tests/test_textures.py's check on the port's own frames at 64²."""
    scene, cam, _ = distant_floor
    settings = tpt.settings_for_scene(scene, max_bounce_count=0,
                                      next_event_sample_count=1)
    img_tri = tpt.render_sample(scene, cam, 64, 64, 0, settings).numpy()
    img_l0 = tpt.render_sample(scene, cam, 64, 64, 0, settings._replace(
        trilinear_textures=False)).numpy()
    horizon = next(i for i in range(64) if img_l0[i].mean() > 1e-4)
    band_tri = img_tri[horizon + 1:horizon + 7].mean(axis=-1)
    band_l0 = img_l0[horizon + 1:horizon + 7].mean(axis=-1)
    row_std_l0 = band_l0.std(axis=1).mean()
    row_std_tri = band_tri.std(axis=1).mean()
    assert row_std_l0 > 2.0 * row_std_tri, (row_std_l0, row_std_tri)
