"""Gradients at min/max/clip ties: the port's ``render_loss_grad`` against
JAX's on a scene whose two materials sit on bounds.

JAX splits a ``jnp.maximum`` / ``minimum`` / ``clip`` gradient half and
half where the operand equals its bound; ``bifrost3d_tpu_torch.math.clip``
does the same. One sphere has roughness exactly 1.0, the upper end of the
rho tables' hat weights (``shading/fittings._hat_weights``: the clip and
the last weight's ``max(0, ·)`` both tie); the other roughness 0.01,
whose float32 square is exactly ``MIN_ALPHA`` = 1e-4, the lower bound of
``alpha_from_roughness``'s ``max``. (Roughness 0.0 would be the tables'
lower end, but there JAX's cotangent is NaN: ``r4 ** 0.25`` of the coat's
roughness modulation has an infinite slope at 0, and JAX's one-hot
material gather spreads the NaN to every material.) A
directional light and a constant environment light the scene, so no
sphere light's cancelling pdf enters. Every float leaf of JAX's cotangent
is matched by field path to the port's, within test_torch_diff_grad.py's
rtol 1e-4, atol 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifrost3d_tpu.diff import render_loss_grad as jax_render_loss_grad
from bifrost3d_tpu.geometry import make_sphere
from bifrost3d_tpu.integrator import path_tracer as jpt
from bifrost3d_tpu.lights.types import LIGHT_DIRECTIONAL
from bifrost3d_tpu.lights.types import LightArray as JaxLightArray
from bifrost3d_tpu.scene.camera import perspective_camera as jax_camera
from bifrost3d_tpu.scene.materials import MaterialArray as JaxMaterialArray
from bifrost3d_tpu.scene.materials import dielectric as jax_dielectric
from bifrost3d_tpu.scene.render_scene import build_render_scene

from bifrost3d_tpu_torch.diff import render_loss_grad
from bifrost3d_tpu_torch.integrator import path_tracer as tpt
from bifrost3d_tpu_torch.scene.camera import camera_from_numpy
from bifrost3d_tpu_torch.scene.render_scene import render_scene_from_numpy
from test_torch_diff_grad import _leaves
from torch_parity import camera_arrays, scene_arrays

W, H = 16, 12
SETTINGS = jpt.RenderSettings(max_bounce_count=2, shading_models_present=(0,),
                              next_event_sample_count=1)
ROUGHNESS = (1.0, 0.01)


def _at(x):
    """A 3 × 4 translation along x."""
    return np.asarray([[1, 0, 0, x], [0, 1, 0, 0], [0, 0, 1, 0]], np.float32)


@pytest.fixture(scope="module")
def grads():
    mats = JaxMaterialArray.build([
        jax_dielectric((0.6, 0.4, 0.2), ROUGHNESS[0]),
        jax_dielectric((0.3, 0.5, 0.7), ROUGHNESS[1])])
    lights = JaxLightArray.build([
        {"kind": LIGHT_DIRECTIONAL, "direction": (0.3, -1.0, -0.4),
         "radiance": (3.0, 3.0, 3.0)}])
    sphere = make_sphere(radius=0.5, slices=24, stacks=12)
    scene = build_render_scene(
        [(sphere, 0, _at(-0.55)), (sphere, 1, _at(0.55))],
        mats, lights, environment_map=np.full((16, 32, 3), 0.3, np.float32))
    # From (0, 0.4, 2.4) two triangles' cotangents differ wholesale, the
    # same two with one bounce or another light: one camera lane resolves
    # to another path in each package (an edge tie of the trace or a
    # flipped float32 decision), not a gradient rule.
    cam = jax_camera(eye=(0, 0.6, 2.6), target=(0, 0, 0))
    np.testing.assert_array_equal(scene.materials.roughness,
                                  np.float32(ROUGHNESS))
    _, jax_grads = jax_render_loss_grad(scene, cam, jnp.zeros((H, W, 3)), W,
                                        H, jnp.uint32(0), SETTINGS)
    port_scene = render_scene_from_numpy(scene_arrays(scene), device="cpu")
    _, port_grads = render_loss_grad(
        port_scene, camera_from_numpy(camera_arrays(cam), device="cpu"),
        torch.zeros(H, W, 3), W, H, 0, tpt.RenderSettings(*SETTINGS))
    return jax_grads, port_grads


def test_tie_cotangents_match_jax(grads):
    """Every float leaf within rtol 1e-4, atol 1e-8; the roughness
    cotangent of both materials is nonzero and compared. Before the
    JAX-rule helpers, torch's clamp passed the whole gradient at both
    ties and the roughness cotangent missed JAX's."""
    jax_grads, port_grads = grads
    ref, got = _leaves(jax_grads), _leaves(port_grads)
    compared = []
    for path, want in ref.items():
        want = np.asarray(want)
        if want.dtype == jax.dtypes.float0 or path not in got:
            continue
        have = got[path].numpy()
        assert have.shape == want.shape, path
        np.testing.assert_allclose(have, want, rtol=1e-4, atol=1e-8,
                                   err_msg=path)
        compared.append(path)
    assert ".materials.roughness" in compared
    assert (np.abs(got[".materials.roughness"].numpy()) > 0).all()
    assert ".materials.tint" in compared
