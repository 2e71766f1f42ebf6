"""The port's sharded geometry train step and silhouette boundary term
against the JAX package's, on the CPU.

tests/test_parallel.py's geometry test scene (the box-on-plane scene of
``test_torch_parallel_train.py`` with the box's roughness 0.9), at
16 × 16, 1 bounce, 8 samples an edge, an 8-shard mesh on each side:

- ``silhouette_translation_boundary_grad`` on the box moved by a seeded
  translation, against JAX's (jitted), at atol 2e-6 and rtol 2e-4;
- one step of ``make_sharded_geometry_train_step``: the loss, the
  gradient (0.1 × the gradient is Adam's first moment after one step)
  and the updated translation, at the same tolerances.

The port's elementary functions are rounded once from float64
(``elementary_rounded_once``), as in ``test_torch_parallel_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifrost3d_tpu.diff.mesh_edge_grad import MeshEdges as JaxMeshEdges
from bifrost3d_tpu.parallel import render_mesh as jax_render_mesh
from bifrost3d_tpu.parallel.render import (
    make_sharded_geometry_train_step as jax_geometry_step,
    silhouette_translation_boundary_grad as jax_boundary,
)

from bifrost3d_tpu_torch.parallel.render import (
    _translated,
    make_sharded_geometry_train_step,
    silhouette_translation_boundary_grad,
)
from test_torch_parallel_train import (
    ATOL,
    CPU8,
    H,
    RTOL,
    W,
    box_on_plane,
    shifted_target,
    to_port,
)
from torch_parity import elementary_rounded_once


@pytest.fixture(scope="module")
def geometry():
    scene, cam, settings, tri_range, edges = box_on_plane(box_roughness=0.9)
    target = shifted_target(scene, cam, settings, tri_range,
                            (0.35, 0.0, 0.0))
    return (scene, cam, settings, tri_range, edges, target,
            to_port(scene, cam, settings, edges))


def test_boundary_term_matches_jax(geometry):
    scene, cam, settings, tri_range, edges, target, port = geometry
    p_scene, p_cam, p_settings, p_edges = port
    t = np.random.default_rng(15).uniform(-0.1, 0.1, 3).astype(np.float32)
    t0, t1 = tri_range
    j_edges = JaxMeshEdges.build(*edges)

    def jax_term(translation):
        shifted = scene._replace(
            tri_verts=scene.tri_verts.at[t0:t1].add(translation),
            tri_components=None, tri_clustered=None)
        return jax_boundary(shifted, translation, cam, target, j_edges, W, H,
                            jnp.uint32(0), settings, 8)

    ref = np.asarray(jax.jit(jax_term)(jnp.asarray(t)))
    translation = torch.tensor(t)
    with elementary_rounded_once():
        got = silhouette_translation_boundary_grad(
            _translated(p_scene, tri_range, translation), translation, p_cam,
            torch.tensor(np.asarray(target)), p_edges, W, H, 0, p_settings, 8)
    assert np.abs(ref).max() > 1e-4, ref       # the silhouette is in view
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_geometry_step_matches_jax(geometry):
    scene, cam, settings, tri_range, edges, target, port = geometry
    p_scene, p_cam, p_settings, p_edges = port
    init_fn, step_fn = jax_geometry_step(
        jax_render_mesh(jax.devices()[:8]), W, H, tri_range,
        JaxMeshEdges.build(*edges), settings=settings, learning_rate=4e-2,
        samples_per_edge=8)
    translation, state = init_fn()
    j_t, j_state, j_loss = step_fn(translation, state, scene, cam, target,
                                   jnp.uint32(0))

    init_fn, step_fn = make_sharded_geometry_train_step(
        CPU8, W, H, tri_range, p_edges, settings=p_settings,
        learning_rate=4e-2, samples_per_edge=8)
    translation, state = init_fn()
    with elementary_rounded_once():
        p_t, p_state, p_loss = step_fn(translation, state, p_scene, p_cam,
                                       torch.tensor(np.asarray(target)), 0)
    np.testing.assert_allclose(float(p_loss), float(j_loss), rtol=RTOL,
                               atol=ATOL)
    grad = p_state.mu["translation"].numpy() / 0.1
    assert np.abs(grad).max() > 0.0
    np.testing.assert_allclose(grad, np.asarray(j_state[0].mu) / 0.1,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(j_t), rtol=RTOL,
                               atol=ATOL)
