"""Path regularization against the JAX package, on the CPU.

``encode_pdf``, ``estimate_ggx_alpha_from_max_pdf`` and
``DefaultShading.create_with_max_pdf_hint`` are deterministic and gated
with ``assert_f64_anchored``. Frames (a glossy CornellBox at 16², 2
bounces, ``path_regularization_scale`` 1.0, the same scene arrays in both
packages) use the statistical gate of tests/test_pallas_mesh.py:25-42 (≤ 3%
of pixels off by more than 1e-3, means within 2%); ``render_sample`` is
run without decay, ``render_sample_pooled`` with
``path_regularization_decay`` 0.5. The gradient over
``materials.roughness`` at 8² (two glossy spheres above a diffuse floor,
regularization on) is held at test_torch_diff_grad.py's rtol 1e-4,
atol 1e-8: every regularized lane's roughness goes through the per-lane
``torch.maximum(roughness, min_roughness)``, which must split a tie's
gradient as ``jnp.maximum`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifrost3d_tpu.apps.scenes import create_cornell_box as jax_cornell_box
from bifrost3d_tpu.diff import render_loss_grad as jax_render_loss_grad
from bifrost3d_tpu.geometry import make_plane, make_sphere
from bifrost3d_tpu.integrator import path_tracer as jpt
from bifrost3d_tpu.lights.types import LIGHT_DIRECTIONAL
from bifrost3d_tpu.lights.types import LightArray as JaxLightArray
from bifrost3d_tpu.scene.camera import perspective_camera as jax_camera
from bifrost3d_tpu.scene.materials import MaterialArray as JaxMaterialArray
from bifrost3d_tpu.scene.materials import dielectric as jax_dielectric
from bifrost3d_tpu.scene.render_scene import build_render_scene
from bifrost3d_tpu.shading import default_shading as jds
from bifrost3d_tpu.shading import fittings as jfit

from bifrost3d_tpu_torch.diff import render_loss_grad
from bifrost3d_tpu_torch.integrator import path_tracer as tpt
from bifrost3d_tpu_torch.scene.camera import camera_from_numpy
from bifrost3d_tpu_torch.scene.render_scene import render_scene_from_numpy
from bifrost3d_tpu_torch.shading import default_shading as tds
from bifrost3d_tpu_torch.shading import fittings as tfit
from test_torch_diff_grad import _leaves
from torch_parity import (
    assert_f64_anchored,
    assert_statistical_gate,
    camera_arrays,
    scene_arrays,
)

RES = 16
BOUNCES = 2
ACCUMULATION = 3
# Per entry: (scale, decay).
REGULARIZATION = {"render_sample": (1.0, 0.0),
                  "render_sample_pooled": (1.0, 0.5)}


def _pdfs(rng, n):
    pdf = np.exp(rng.normal(0.0, 3.0, n)).astype(np.float32)
    pdf[:4] = (0.0, 1e-3, 0.13 / 0.87, 1e6)
    return pdf


def test_encode_pdf():
    pdf = _pdfs(np.random.default_rng(1), 4096)
    assert_f64_anchored(tfit.encode_pdf, jfit.encode_pdf, pdf)


def test_estimate_ggx_alpha_from_max_pdf():
    rng = np.random.default_rng(2)
    cos_theta = rng.random(4096).astype(np.float32)
    cos_theta[:3] = (0.0, 1.0, 0.5)
    assert_f64_anchored(tfit.estimate_ggx_alpha_from_max_pdf,
                        jfit.estimate_ggx_alpha_from_max_pdf, cos_theta,
                        _pdfs(rng, 4096))


def test_create_with_max_pdf_hint():
    rng = np.random.default_rng(3)
    n = 2048
    f32 = np.float32
    args = (rng.random((n, 3)).astype(f32),          # tint
            rng.random(n).astype(f32),               # roughness
            rng.random(n).astype(f32) * 0.2,         # specularity
            (rng.random(n) > 0.7).astype(f32),       # metallic
            (rng.random(n) > 0.5).astype(f32),       # coat
            rng.random(n).astype(f32),               # coat roughness
            rng.random(n).astype(f32) * 0.98 + 0.01,  # |cos theta_o|
            _pdfs(rng, n),                           # max pdf
            rng.random(n) > 0.8)                     # pdf is delta
    assert_f64_anchored(tds.DefaultShading.create_with_max_pdf_hint,
                        jds.DefaultShading.create_with_max_pdf_hint, *args)


def _glossy(scene):
    """CornellBox with its materials glossy (roughness 0.05–0.4), so the
    regularization's floor is above the surfaces' own roughness."""
    m = scene.materials
    roughness = np.resize(np.float32([0.05, 0.1, 0.2, 0.4]),
                          m.roughness.shape)
    return scene._replace(materials=m._replace(
        roughness=jnp.asarray(roughness)))


@pytest.fixture(scope="module")
def glossy_cornell():
    jscene, jcam = jax_cornell_box()
    jscene = _glossy(jscene)
    refs = {}
    for entry, (scale, decay) in REGULARIZATION.items():
        settings = jpt.settings_for_scene(
            jscene, max_bounce_count=BOUNCES, path_regularization_scale=scale,
            path_regularization_decay=decay)
        refs[entry] = np.asarray(getattr(jpt, entry)(
            jscene, jcam, RES, RES, jnp.uint32(ACCUMULATION), settings))
    scene = render_scene_from_numpy(scene_arrays(jscene), device="cpu")
    cam = camera_from_numpy(camera_arrays(jcam), device="cpu")
    return scene, cam, refs


@pytest.mark.parametrize("entry", sorted(REGULARIZATION))
def test_regularized_frame_matches_jax(glossy_cornell, entry):
    scene, cam, refs = glossy_cornell
    scale, decay = REGULARIZATION[entry]
    settings = tpt.settings_for_scene(
        scene, max_bounce_count=BOUNCES, path_regularization_scale=scale,
        path_regularization_decay=decay)
    img = getattr(tpt, entry)(scene, cam, RES, RES, ACCUMULATION, settings)
    assert_statistical_gate(img.numpy(), refs[entry])
    # The regularization changes the frame: without it the gate fails.
    plain = getattr(tpt, entry)(
        scene, cam, RES, RES, ACCUMULATION,
        settings._replace(path_regularization_scale=0.0))
    d = np.abs(plain.numpy() - refs[entry]).max(-1)
    assert (d > 1e-3).mean() > 0.03, (d > 1e-3).mean()


def test_regularization_is_a_megakernel_reason(glossy_cornell):
    from bifrost3d_tpu_torch.integrator.pallas_mesh import (
        megakernel_ineligibility_reasons)
    scene, _, _ = glossy_cornell
    settings = tpt.RenderSettings(path_regularization_scale=1.0)
    assert "path regularization" in megakernel_ineligibility_reasons(
        scene, settings)
    assert "path regularization" in tpt.explain_render_path(scene, settings)


GW, GH = 8, 8
GRAD_SETTINGS = jpt.RenderSettings(
    max_bounce_count=2, shading_models_present=(0,),
    next_event_sample_count=1, path_regularization_scale=1.0)


def _at(x, y=0.0):
    return np.asarray([[1, 0, 0, x], [0, 1, 0, y], [0, 0, 1, 0]], np.float32)


@pytest.fixture(scope="module")
def regularized_grads():
    mats = JaxMaterialArray.build([
        jax_dielectric((0.6, 0.4, 0.2), 0.05),
        jax_dielectric((0.3, 0.5, 0.7), 0.15),
        # Not 1.0: at the rho tables' upper end a lane's roughness
        # cotangent jumps ~5x across the kink, and a one-ulp difference
        # of the hit's u, v (so of its interpolated tint-roughness scale)
        # moves a lane across it (ROADMAP, known behaviours).
        jax_dielectric((0.7, 0.7, 0.7), 0.9)])
    lights = JaxLightArray.build([
        {"kind": LIGHT_DIRECTIONAL, "direction": (0.3, -1.0, -0.4),
         "radiance": (3.0, 3.0, 3.0)}])
    sphere = make_sphere(radius=0.5, slices=16, stacks=8)
    scene = build_render_scene(
        [(sphere, 0, _at(-0.55)), (sphere, 1, _at(0.55)),
         (make_plane(size=4.0), 2, _at(0.0, -0.5))],
        mats, lights, environment_map=np.full((16, 32, 3), 0.3, np.float32))
    cam = jax_camera(eye=(0, 0.6, 2.6), target=(0, 0, 0))
    _, jax_grads = jax_render_loss_grad(scene, cam, jnp.zeros((GH, GW, 3)),
                                        GW, GH, jnp.uint32(1), GRAD_SETTINGS)
    port_scene = render_scene_from_numpy(scene_arrays(scene), device="cpu")
    port_cam = camera_from_numpy(camera_arrays(cam), device="cpu")
    settings = tpt.RenderSettings(*GRAD_SETTINGS)
    _, port_grads = render_loss_grad(port_scene, port_cam,
                                     torch.zeros(GH, GW, 3), GW, GH, 1,
                                     settings)
    _, plain_grads = render_loss_grad(
        port_scene, port_cam, torch.zeros(GH, GW, 3), GW, GH, 1,
        settings._replace(path_regularization_scale=0.0))
    return jax_grads, port_grads, plain_grads


def test_regularized_roughness_gradient_matches_jax(regularized_grads):
    jax_grads, port_grads, plain_grads = regularized_grads
    ref, got = _leaves(jax_grads), _leaves(port_grads)
    for path in (".materials.roughness", ".materials.tint"):
        want = np.asarray(ref[path])
        assert want.dtype != jax.dtypes.float0
        np.testing.assert_allclose(got[path].numpy(), want, rtol=1e-4,
                                   atol=1e-8, err_msg=path)
    # The floor moved the glossy spheres' roughness cotangents.
    rough = got[".materials.roughness"].numpy()
    plain = _leaves(plain_grads)[".materials.roughness"].numpy()
    assert not np.allclose(rough[:2], plain[:2], rtol=1e-3), (rough, plain)
