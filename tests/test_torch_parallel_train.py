"""The port's sharded train step against the JAX package's, on the CPU.

One step of ``make_sharded_train_step`` with a geometry translation and
its silhouette boundary term (``tri_range``, ``object_edges``) on the
box-on-plane scene of tests/test_parallel.py's unified test, at 16 × 16,
1 bounce, 8 samples an edge, over an 8-shard mesh on each side (JAX's
conftest's 8 CPU devices, the port's ``[cpu] * 8``). The scene and the
target are JAX's, carried across as numpy.

Compared: the loss, every gradient (both sides' Adam first moment after
one step is 0.1 × the gradient, so the gradients are read from the
optimizer state) and the updated parameters, at tests/test_parallel.py's
all-reduce tolerances, atol 2e-6 and rtol 2e-4, with the port's elementary
functions rounded once from float64 (``elementary_rounded_once``; the two
estimators differ by float32 reassociation only). The updated parameters
are ``p − lr · g / (|g| + eps)`` to first order, so they agree wherever
the gradients' signs do.

The file keeps to one JAX train-step compile (about 45 s on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifrost3d_tpu.diff.mesh_edge_grad import MeshEdges as JaxMeshEdges
from bifrost3d_tpu.geometry import make_box, make_plane
from bifrost3d_tpu.integrator import path_tracer as jpt
from bifrost3d_tpu.lights.types import LIGHT_SPHERE, LightArray
from bifrost3d_tpu.parallel import make_sharded_train_step as jax_train_step
from bifrost3d_tpu.parallel import render_mesh as jax_render_mesh
from bifrost3d_tpu.scene.camera import perspective_camera
from bifrost3d_tpu.scene.materials import MaterialArray, dielectric
from bifrost3d_tpu.scene.render_scene import build_render_scene

from bifrost3d_tpu_torch.diff import render_loss_grad
from bifrost3d_tpu_torch.diff.mesh_edge_grad import MeshEdges
from bifrost3d_tpu_torch.integrator import path_tracer as tpt
from bifrost3d_tpu_torch.parallel import make_sharded_train_step
from bifrost3d_tpu_torch.parallel.render import GEOMETRY_MAX_TRIS
from bifrost3d_tpu_torch.scene.camera import camera_from_numpy
from bifrost3d_tpu_torch.scene.render_scene import render_scene_from_numpy
from torch_parity import camera_arrays, elementary_rounded_once, scene_arrays

W = H = 16
CPU8 = [torch.device("cpu")] * 8
LIFT = (0.0, 0.9, 0.0)
ATOL, RTOL = 2e-6, 2e-4


def box_on_plane(box_roughness=0.6):
    """tests/test_parallel.py's scene: a 0.8 box lifted 0.9 above a 6 × 6
    plane under a sphere light → (JAX scene, camera, settings, the box's
    triangle range, the box's edges as (positions, indices))."""
    mats = MaterialArray.build([
        dielectric((0.8, 0.8, 0.8), 0.9),
        dielectric((0.9, 0.2, 0.2), box_roughness),
    ])
    floor = make_plane(size=6.0)
    box = make_box(size=0.8)
    lights = LightArray.build([
        {"kind": LIGHT_SPHERE, "position": (0.5, 2.5, -0.5),
         "radius": 0.2, "power": (40.0, 40.0, 40.0)}])
    scene = build_render_scene([(floor, 0, None), (box, 1, None)], mats,
                               lights)
    n_floor = np.asarray(floor.indices).reshape(-1, 3).shape[0]
    n_box = np.asarray(box.indices).reshape(-1, 3).shape[0]
    tri_range = (n_floor, n_floor + n_box)
    scene = scene._replace(tri_verts=scene.tri_verts.at[
        tri_range[0]:tri_range[1]].add(jnp.asarray(LIFT)))
    cam = perspective_camera(eye=(0.0, 2.2, -3.0), target=(0, 0.6, 0))
    settings = jpt.settings_for_scene(scene, max_bounce_count=1,
                                      next_event_sample_count=1)
    edges = (np.asarray(box.positions) + np.asarray(LIFT),
             np.asarray(box.indices))
    return scene, cam, settings, tri_range, edges


def shifted_target(scene, cam, settings, tri_range, shift, tint=None):
    """JAX's target frame: the box moved by ``shift`` (and retinted)."""
    t0, t1 = tri_range
    target = scene._replace(tri_verts=scene.tri_verts.at[t0:t1].add(
        jnp.asarray(shift, jnp.float32)))
    if tint is not None:
        target = target._replace(materials=target.materials._replace(
            tint=target.materials.tint.at[1].set(jnp.asarray(tint))))
    return jpt.render_sample(target, cam, W, H, jnp.uint32(0), settings)


def to_port(scene, cam, settings, edges):
    return (render_scene_from_numpy(scene_arrays(scene), device="cpu"),
            camera_from_numpy(camera_arrays(cam), device="cpu"),
            tpt.RenderSettings(*settings),
            MeshEdges.build(*edges, device="cpu"))


@pytest.fixture(scope="module")
def unified_step():
    """One step of the unified train step on both sides."""
    scene, cam, settings, tri_range, edges = box_on_plane()
    target = shifted_target(scene, cam, settings, tri_range, (0.3, 0.0, 0.0),
                            tint=(0.2, 0.8, 0.3))
    init_fn, step_fn = jax_train_step(
        jax_render_mesh(jax.devices()[:8]), W, H, settings,
        learning_rate=2e-2, tri_range=tri_range,
        object_edges=JaxMeshEdges.build(*edges), samples_per_edge=8)
    params, opt_state = init_fn(scene)
    j_params, j_state, j_loss = step_fn(params, opt_state, scene, cam, target,
                                        jnp.uint32(0))
    jax_out = dict(loss=float(j_loss),
                   grads={k: np.asarray(v) / 0.1
                          for k, v in j_state[0].mu.items()},
                   params={k: np.asarray(v) for k, v in j_params.items()})

    p_scene, p_cam, p_settings, p_edges = to_port(scene, cam, settings, edges)
    init_fn, step_fn = make_sharded_train_step(
        CPU8, W, H, p_settings, learning_rate=2e-2, tri_range=tri_range,
        object_edges=p_edges, samples_per_edge=8)
    p_target = torch.tensor(np.asarray(target))

    def port_step():
        params, opt_state = init_fn(p_scene)
        params, state, loss = step_fn(params, opt_state, p_scene, p_cam,
                                      p_target, 0)
        return dict(loss=float(loss),
                    grads={k: (v / 0.1).numpy() for k, v in state.mu.items()},
                    params={k: v.numpy() for k, v in params.items()},
                    count=state.count)

    with elementary_rounded_once():
        port_out = port_step()
    return jax_out, port_out, (p_scene, p_cam, p_settings, p_target)


def test_unified_step_loss_matches_jax(unified_step):
    jax_out, port_out, _ = unified_step
    assert port_out["count"] == 1
    np.testing.assert_allclose(port_out["loss"], jax_out["loss"], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name", ["tint", "roughness", "specularity",
                                  "metallic", "emission", "light_power",
                                  "translation"])
def test_unified_step_gradient_matches_jax(unified_step, name):
    jax_out, port_out, _ = unified_step
    got, ref = port_out["grads"][name], jax_out["grads"][name]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["tint", "roughness", "specularity",
                                  "metallic", "emission", "light_power",
                                  "translation"])
def test_unified_step_parameters_match_jax(unified_step, name):
    jax_out, port_out, _ = unified_step
    np.testing.assert_allclose(port_out["params"][name],
                               jax_out["params"][name], rtol=RTOL, atol=ATOL)


def test_sharded_gradient_equals_unsharded(unified_step):
    """The port's material gradient summed over 8 shards (and over 3, whose
    row split pads 16 rows to 18) equals its own unsharded
    ``render_loss_grad`` at the all-reduce tolerances."""
    from bifrost3d_tpu_torch.parallel.render import _sharded_loss_grads
    _, _, (scene, cam, settings, target) = unified_step
    loss_ref, grads_ref = render_loss_grad(scene, cam, target, W, H, 0,
                                           settings)
    params = {"tint": scene.materials.tint,
              "roughness": scene.materials.roughness,
              "light_power": scene.lights.power}

    def scene_of(d, p):
        mats = scene.materials._replace(tint=p["tint"],
                                        roughness=p["roughness"])
        return scene._replace(materials=mats,
                              lights=scene.lights._replace(
                                  power=p["light_power"]))

    for mesh in (CPU8, [torch.device("cpu")] * 3):
        loss, grads = _sharded_loss_grads(mesh, params, scene_of, cam, target,
                                          W, H, 0, settings)
        np.testing.assert_allclose(float(loss), float(loss_ref), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(grads["tint"].numpy(),
                                   grads_ref.materials.tint.numpy(),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(grads["roughness"].numpy(),
                                   grads_ref.materials.roughness.numpy(),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(grads["light_power"].numpy(),
                                   grads_ref.lights.power.numpy(),
                                   rtol=RTOL, atol=ATOL)


def test_geometry_step_refuses_large_scenes(unified_step):
    """Above JAX's limit the moved scene would need a new BVH: both
    packages raise."""
    _, _, (scene, cam, settings, target) = unified_step
    big = scene._replace(tri_verts=torch.zeros((GEOMETRY_MAX_TRIS + 1, 3, 3)))
    init_fn, step_fn = make_sharded_train_step(CPU8, W, H, settings,
                                               tri_range=(0, 1))
    params, state = init_fn(scene)
    with pytest.raises(ValueError, match="supports scenes up to"):
        step_fn(params, state, big, cam, target, 0)
