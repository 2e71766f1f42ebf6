"""Gradients through the Transmissive model: the port's
``render_loss_grad`` against JAX's on a glass sphere over a floor.

The scene: a rough glass sphere (roughness 0.3) and a Default floor,
under a directional light and a constant environment, 16 × 12, 2
bounces, models Default and Transmissive. The paths refract into and out
of the sphere, so the cotangents of the glass's tint and roughness come
through ``TransmissiveShading``, the combined GGX lobe and the dielectric
rho table. Both are held at test_torch_diff_grad.py's rtol 1e-4, atol
1e-8. Every other float leaf is held at rtol 1e-4
with an atol of 1e-5 of the leaf's largest entry: the per-triangle
roughness scale's cotangent has entries a millionth of its largest that
move by up to 5.6e-6 of it (measured), float32 reassociation summed over
the refracted paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifrost3d_tpu.diff import render_loss_grad as jax_render_loss_grad
from bifrost3d_tpu.geometry import make_plane, make_sphere
from bifrost3d_tpu.integrator import path_tracer as jpt
from bifrost3d_tpu.lights.types import LIGHT_DIRECTIONAL
from bifrost3d_tpu.lights.types import LightArray as JaxLightArray
from bifrost3d_tpu.scene.camera import perspective_camera as jax_camera
from bifrost3d_tpu.scene.materials import MaterialArray as JaxMaterialArray
from bifrost3d_tpu.scene.materials import dielectric as jax_dielectric
from bifrost3d_tpu.scene.materials import transmissive as jax_transmissive
from bifrost3d_tpu.scene.render_scene import build_render_scene

from bifrost3d_tpu_torch.diff import render_loss_grad
from bifrost3d_tpu_torch.integrator import path_tracer as tpt
from bifrost3d_tpu_torch.scene.camera import camera_from_numpy
from bifrost3d_tpu_torch.scene.render_scene import render_scene_from_numpy
from test_torch_diff_grad import _leaves
from torch_parity import camera_arrays, scene_arrays

W, H = 16, 12
SETTINGS = jpt.RenderSettings(max_bounce_count=2,
                              shading_models_present=(0, 2),
                              next_event_sample_count=1)


@pytest.fixture(scope="module")
def grads():
    mats = JaxMaterialArray.build([
        jax_dielectric((0.6, 0.6, 0.6), 0.8),
        jax_transmissive((0.9, 0.6, 0.4), 0.3)])
    lights = JaxLightArray.build([
        {"kind": LIGHT_DIRECTIONAL, "direction": (0.3, -1.0, 0.4),
         "radiance": (3.0, 3.0, 3.0)}])
    floor = np.asarray([[1, 0, 0, 0], [0, 1, 0, -0.5], [0, 0, 1, 0]],
                       np.float32)
    scene = build_render_scene(
        [(make_plane(size=6.0), 0, floor),
         (make_sphere(radius=0.5, slices=24, stacks=12), 1, None)],
        mats, lights, environment_map=np.full((16, 32, 3), 0.3, np.float32))
    cam = jax_camera(eye=(0, 0.5, 2.2), target=(0, 0, 0))
    _, jax_grads = jax_render_loss_grad(scene, cam, jnp.zeros((H, W, 3)), W,
                                        H, jnp.uint32(0), SETTINGS)
    port_scene = render_scene_from_numpy(scene_arrays(scene), device="cpu")
    assert port_scene.shading_models == (0, 2)
    _, port_grads = render_loss_grad(
        port_scene, camera_from_numpy(camera_arrays(cam), device="cpu"),
        torch.zeros(H, W, 3), W, H, 0, tpt.RenderSettings(*SETTINGS))
    return jax_grads, port_grads


def test_transmissive_cotangents_match_jax(grads):
    jax_grads, port_grads = grads
    ref, got = _leaves(jax_grads), _leaves(port_grads)
    compared = []
    for path, want in ref.items():
        want = np.asarray(want)
        if want.dtype == jax.dtypes.float0 or path not in got:
            continue
        have = got[path].numpy()
        assert have.shape == want.shape, path
        atol = 1e-8 if path.startswith(".materials.") or not want.size \
            else 1e-5 * float(np.abs(want).max())
        np.testing.assert_allclose(have, want, rtol=1e-4, atol=atol,
                                   err_msg=path)
        compared.append(path)
    for path in (".materials.tint", ".materials.roughness"):
        assert path in compared
        # The glass's own row has a cotangent.
        assert np.abs(got[path].numpy()[1]).max() > 0, path
