"""The port's edge-sampled geometry gradients (``diff/edge_grad.py``,
``diff/mesh_edge_grad.py``) against the JAX package's on the same inputs,
and each against central differences of its forward, on the CPU.

The scenes and tolerances of the finite-difference checks are those of
tests/test_edge_grad.py and tests/test_diff.py:129-190, 310-390. Against
JAX, both sides probe the same rays: the boundary terms agree to float32
reassociation in the forward-mode Jacobians, held at rtol 1e-4 and atol
1e-9 (measured on the CPU: at most 3.7e-9 absolute, and at most 9.2e-5
relative, on a component whose difference is 2e-10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifrost3d_tpu.diff import edge_grad as jeg
from bifrost3d_tpu.diff import mesh_edge_grad as jmeg
from bifrost3d_tpu.geometry import make_box, make_plane
from bifrost3d_tpu.geometry.traverse import (
    intersect_triangles_brute as jax_brute)
from bifrost3d_tpu.scene import smallpt_scene as jax_smallpt_scene
from bifrost3d_tpu.scene.camera import perspective_camera as jax_camera

from bifrost3d_tpu_torch.diff import edge_grad as teg
from bifrost3d_tpu_torch.diff import mesh_edge_grad as tmeg
from bifrost3d_tpu_torch.geometry.traverse import intersect_triangles_brute
from bifrost3d_tpu_torch.scene.camera import (
    camera_from_numpy,
    camera_ray_directions,
)
from bifrost3d_tpu_torch.scene.spheres import (
    SphereScene,
    sphere_scene_from_numpy,
)
from torch_parity import camera_arrays, sphere_scene_arrays

W, H = 64, 48
# Agreement with JAX: rtol 1e-4, and atol for components near zero.
RTOL, ATOL = 1e-4, 1e-9


def _one_sphere(center) -> SphereScene:
    """tests/test_edge_grad.py's emissive sphere of radius 16.5."""
    z = np.zeros
    return sphere_scene_from_numpy(dict(
        position=[center], radius=[16.5], emission=[[1.0, 1.0, 1.0]],
        color=z((1, 3)), bsdf=z(1, np.int32), medium_sigma_t=z(1),
        medium_albedo=z(1), medium_g=z(1)), device="cpu")


def _jax_spheres(scene: SphereScene):
    from bifrost3d_tpu.scene.spheres import SphereScene as JaxSpheres
    return JaxSpheres(*(jnp.asarray(f.numpy()) for f in scene))


BASE = np.asarray([27.0, 16.5, 47.0], np.float32)


# -- analytic spheres --------------------------------------------------------------

def test_silhouette_and_screen_coords_match_jax():
    center = torch.tensor(BASE)
    cam_o = torch.tensor([50.0, 52.0, 295.6])
    phis = torch.linspace(0.05, 6.2, 64)
    for delta in (0.0, -1e-3, 1e-3):
        got = teg.silhouette_direction(center, torch.tensor(16.5), cam_o,
                                       phis, delta)
        want = jax.vmap(lambda p: jeg.silhouette_direction(
            jnp.asarray(BASE), 16.5, jnp.asarray(cam_o.numpy()), p, delta))(
                jnp.asarray(phis.numpy()))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    q, s = teg.screen_coords(got, W, H)
    jq, js = jax.vmap(lambda w: jeg.screen_coords(w, W, H))(want)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)


def test_direct_emission_matches_jax():
    scene = _one_sphere(BASE)
    got = float(teg.direct_emission_image(scene, W, H, samples_per_pixel=4))
    want = float(jeg.direct_emission_image(_jax_spheres(scene), W, H, 4))
    assert 0.0 < got < 1.0
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_single_sphere_edge_gradient_matches_jax_and_fd():
    """tests/test_edge_grad.py's single sphere: the port's boundary term
    against JAX's (same 2,048 edge samples) and against central
    differences of the stratified forward (16 × 16 sub-pixels), with
    JAX's tolerances: axis 0 rtol 0.2 / atol 3e-6, axis 2 rtol 0.05."""
    scene = _one_sphere(BASE)
    g = teg.edge_position_gradient(scene, 0, W, H, n_samples=2048).numpy()
    want = np.asarray(jeg.edge_position_gradient(_jax_spheres(scene), 0, W,
                                                 H, n_samples=2048))
    np.testing.assert_allclose(g, want, rtol=RTOL, atol=ATOL)

    def fwd(c):
        return float(teg.direct_emission_image(_one_sphere(c), W, H,
                                               samples_per_pixel=16))

    for axis, rtol, atol in ((0, 0.2, 3e-6), (2, 0.05, 0.0)):
        e = np.zeros(3, np.float32)
        e[axis] = 1.0
        fd = (fwd(BASE + e) - fwd(BASE - e)) / 2.0
        np.testing.assert_allclose(g[axis], fd, rtol=rtol, atol=atol)
    assert g[2] > 1e-4, g


def test_smallpt_position_gradient_matches_jax_and_fd():
    """tests/test_edge_grad.py's nine-sphere scene with an emissive mirror
    ball: pathwise (zero here: first-hit emission only sees visibility)
    plus boundary, against JAX's and against central differences (axis 2
    rtol 0.05; axis 0 rtol 0.5, atol 3e-6)."""
    jscene = jax_smallpt_scene()
    jscene = jscene._replace(
        emission=jscene.emission.at[6].set(jnp.asarray([2.0, 1.0, 0.5])))
    scene = sphere_scene_from_numpy(sphere_scene_arrays(jscene), device="cpu")

    def fwd(s):
        return teg.direct_emission_image(s, W, H, samples_per_pixel=16)

    g = teg.smallpt_position_gradient(scene, 6, W, H, fwd,
                                      n_samples=2048).numpy()
    want = np.asarray(jeg.smallpt_position_gradient(
        jscene, 6, W, H,
        lambda s: jeg.direct_emission_image(s, W, H, samples_per_pixel=4),
        n_samples=2048))
    np.testing.assert_allclose(g, want, rtol=RTOL, atol=ATOL)

    def f(axis, dx):
        position = scene.position.clone()
        position[6, axis] += dx
        return float(fwd(scene._replace(position=position)))

    np.testing.assert_allclose(g[2], f(2, 0.5) - f(2, -0.5), rtol=0.05)
    np.testing.assert_allclose(g[0], f(0, 0.5) - f(0, -0.5), rtol=0.5,
                               atol=3e-6)


# -- triangle meshes ---------------------------------------------------------------

def _tris(mesh):
    return np.asarray(mesh.positions)[np.asarray(mesh.indices)].astype(
        np.float32)


@pytest.fixture(scope="module")
def box_scene():
    """tests/test_diff.py:129-190's floating box over a floor, both tints
    per object, seen from (1.3, 1.5, 2.4); each side's camera and
    first-hit radiance."""
    box, floor = make_box(size=0.8), make_plane(size=6.0)
    jcam = jax_camera(eye=(1.3, 1.5, 2.4), target=(0, 0.3, 0))
    cam = camera_from_numpy(camera_arrays(jcam), device="cpu")
    return box, _tris(floor), _tris(box), jcam, cam


def _first_hit_tint(floor, box, t, backend):
    tints = (0.2, 0.55)
    if backend == "jax":
        tris = jnp.concatenate([jnp.asarray(floor), jnp.asarray(box) + t], 0)

        def fn(origin, direction):
            hit = jax_brute(tris, origin, direction, 1e-4, jnp.inf)
            return jnp.where(hit.prim >= 0, jnp.where(
                hit.prim >= floor.shape[0], tints[1], tints[0]), 0.0)
        return fn
    tris = torch.cat([torch.tensor(floor), torch.tensor(box) + t], 0)

    def fn(origin, direction):
        hit = intersect_triangles_brute(tris, origin, direction, 1e-4)
        return torch.where(hit.prim >= 0, torch.where(
            hit.prim >= floor.shape[0], tints[1], tints[0]), 0.0)
    return fn


def _grid_forward(cam, radiance):
    """Mean radiance over a 384² grid of the image square (the FD side)."""
    m = 384
    u = (torch.arange(m, dtype=torch.float32) + 0.5) / m
    vv, uu = torch.meshgrid(u, u, indexing="ij")
    o, d = camera_ray_directions(
        cam, torch.stack([uu.reshape(-1), vv.reshape(-1)], dim=-1))
    return lambda t: float(torch.mean(radiance(t)(o, d)))


def test_mesh_edges_match_jax(box_scene):
    box = box_scene[0]
    got = tmeg.MeshEdges.build(box.positions, box.indices, device="cpu")
    want = jmeg.MeshEdges.build(box.positions, box.indices)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got.v0.shape[0] > 0


def test_box_translation_gradient_matches_jax_and_fd(box_scene):
    """The box translation boundary term (64 samples an edge) against
    JAX's, and against central differences of the 384² first-hit forward
    (h = 0.06; axes 0 and 1, rtol 0.12, atol 2e-4)."""
    box, floor, box_tris, jcam, cam = box_scene
    base = np.asarray([0.05, 0.62, 0.0], np.float32)
    edges = tmeg.MeshEdges.build(box.positions, box.indices, device="cpu")
    g = tmeg.edge_translation_gradient(
        cam, edges, torch.tensor(base),
        _first_hit_tint(floor, box_tris, torch.tensor(base), "torch"),
        samples_per_edge=64, edge_eps=1e-3).numpy()
    want = np.asarray(jmeg.edge_translation_gradient(
        jcam, jmeg.MeshEdges.build(box.positions, box.indices),
        jnp.asarray(base),
        _first_hit_tint(floor, box_tris, jnp.asarray(base), "jax"),
        samples_per_edge=64, edge_eps=1e-3))
    np.testing.assert_allclose(g, want, rtol=RTOL, atol=ATOL)
    assert np.all(np.isfinite(g)) and np.max(np.abs(g)) > 1e-3, g

    forward = _grid_forward(cam, lambda t: _first_hit_tint(
        floor, box_tris, t, "torch"))
    h = 0.06
    for axis in (0, 1):
        e = np.zeros(3, np.float32)
        e[axis] = h
        fd = (forward(torch.tensor(base + e))
              - forward(torch.tensor(base - e))) / (2 * h)
        np.testing.assert_allclose(g[axis], fd, rtol=0.12, atol=2e-4)


def test_vertex_gradient_matches_jax_and_translation_sum(box_scene):
    """The per-vertex boundary term (32 samples an edge) against JAX's, and
    summed over the vertices equal to the translation term (rtol 1e-4,
    atol 1e-7), as tests/test_diff.py:364-390."""
    box, floor, box_tris, jcam, cam = box_scene
    base = np.asarray([0.05, 0.62, 0.0], np.float32)
    n_verts = np.asarray(box.positions).shape[0]
    edges = tmeg.MeshEdges.build(box.positions, box.indices, device="cpu")
    radiance = _first_hit_tint(floor, box_tris, torch.tensor(base), "torch")
    g_v = tmeg.edge_vertex_gradient(cam, edges, torch.tensor(base), radiance,
                                    n_verts, samples_per_edge=32).numpy()
    g_t = tmeg.edge_translation_gradient(cam, edges, torch.tensor(base),
                                         radiance, samples_per_edge=32)
    want = np.asarray(jmeg.edge_vertex_gradient(
        jcam, jmeg.MeshEdges.build(box.positions, box.indices),
        jnp.asarray(base),
        _first_hit_tint(floor, box_tris, jnp.asarray(base), "jax"), n_verts,
        samples_per_edge=32))
    np.testing.assert_allclose(g_v, want, rtol=RTOL, atol=ATOL)
    assert (np.abs(g_v).sum(axis=1) > 0).sum() >= 4
    np.testing.assert_allclose(g_v.sum(axis=0), g_t.numpy(), rtol=1e-4,
                               atol=1e-7)


def _shadow_radiance(floor, box, light, t, backend):
    """tests/test_diff.py:218-256's direct-light forward: box pixels flat,
    floor pixels lit by a point light through a binary shadow test."""
    xp = jnp if backend == "jax" else torch
    n_floor = floor.shape[0]
    if backend == "jax":
        blocker = jnp.asarray(box) + t
        tris = jnp.concatenate([jnp.asarray(floor), blocker], 0)

        def trace(tr, o, d, t_max):
            return jax_brute(tr, o, d, 1e-4, t_max)
    else:
        blocker = torch.tensor(box) + t
        tris = torch.cat([torch.tensor(floor), blocker], 0)

        def trace(tr, o, d, t_max):
            return intersect_triangles_brute(tr, o, d, 1e-4, t_max)

    def fn(origin, direction):
        hit = trace(tris, origin, direction, float("inf"))
        p = origin + direction * hit.t[..., None]
        to_l = light - p
        d2 = xp.sum(to_l * to_l, axis=-1) if backend == "jax" else \
            torch.sum(to_l * to_l, dim=-1)
        dist = xp.sqrt(xp.maximum(d2, 1e-12)) if backend == "jax" else \
            torch.sqrt(torch.clamp_min(d2, 1e-12))
        ldir = to_l / dist[..., None]
        sh = trace(blocker, p + ldir * 1e-3, ldir, dist - 2e-3)
        vis = xp.where(sh.prim >= 0, 0.0, 1.0)
        cos_f = (xp.maximum(ldir[..., 1], 0.0) if backend == "jax"
                 else torch.clamp_min(ldir[..., 1], 0.0))
        floor_l = 0.2 * 2.0 * cos_f * vis / (
            xp.maximum(d2, 1e-6) if backend == "jax"
            else torch.clamp_min(d2, 1e-6))
        val = xp.where(hit.prim >= n_floor, 0.55, floor_l)
        return xp.where(hit.prim >= 0, val, 0.0)
    return fn


def _floor_receiver(backend):
    """The receiver plane y = 0 (static) → occluder_fn."""
    if backend == "jax":
        def fn(origin, direction):
            dy = direction[:, 1]
            t = -origin[:, 1] / jnp.where(jnp.abs(dy) > 1e-9, dy, 1e-9)
            t = jnp.where((dy < 0.0) & (t > 0.0), t, jnp.inf)
            return (t, jnp.broadcast_to(jnp.asarray([0.0, 0.0, 0.0]),
                                        origin.shape),
                    jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]),
                                     origin.shape))
        return fn

    def fn(origin, direction):
        dy = direction[:, 1]
        t = -origin[:, 1] / torch.where(torch.abs(dy) > 1e-9, dy, 1e-9)
        t = torch.where((dy < 0.0) & (t > 0.0), t, float("inf"))
        return (t, torch.zeros_like(origin),
                torch.tensor([0.0, 1.0, 0.0]).expand_as(origin))
    return fn


def test_shadow_edge_gradient_matches_jax_and_fd():
    """tests/test_diff.py:258-296: a 0.6 box over the floor lit by a point
    light at (0.6, 2.5, 0.45). The shadow term (64 samples an edge,
    edge_eps 1.5e-3) against JAX's; primary plus shadow against central
    differences (h = 0.05; axes 0 and 2, rtol 0.2, atol 3e-4); the shadow
    term above 1e-4."""
    box, floor = make_box(size=0.6), make_plane(size=8.0)
    floor_tris, box_tris = _tris(floor), _tris(box)
    light = np.asarray([0.6, 2.5, 0.45], np.float32)
    base = np.asarray([0.0, 0.9, 0.0], np.float32)
    jcam = jax_camera(eye=(0.4, 2.6, -3.2), target=(0, 0.4, 0))
    cam = camera_from_numpy(camera_arrays(jcam), device="cpu")
    edges = tmeg.MeshEdges.build(box.positions, box.indices, device="cpu")
    radiance = _shadow_radiance(floor_tris, box_tris, torch.tensor(light),
                                torch.tensor(base), "torch")
    g_shadow = tmeg.shadow_edge_translation_gradient(
        cam, edges, torch.tensor(base), torch.tensor(light), radiance,
        _floor_receiver("torch"), samples_per_edge=64,
        edge_eps=1.5e-3).numpy()
    want = np.asarray(jmeg.shadow_edge_translation_gradient(
        jcam, jmeg.MeshEdges.build(box.positions, box.indices),
        jnp.asarray(base), jnp.asarray(light),
        _shadow_radiance(floor_tris, box_tris, jnp.asarray(light),
                         jnp.asarray(base), "jax"),
        _floor_receiver("jax"), samples_per_edge=64, edge_eps=1.5e-3))
    np.testing.assert_allclose(g_shadow, want, rtol=RTOL, atol=ATOL)
    assert np.max(np.abs(g_shadow)) > 1e-4, g_shadow

    g = g_shadow + tmeg.edge_translation_gradient(
        cam, edges, torch.tensor(base), radiance, samples_per_edge=64,
        edge_eps=1.5e-3).numpy()
    forward = _grid_forward(cam, lambda t: _shadow_radiance(
        floor_tris, box_tris, torch.tensor(light), t, "torch"))
    h = 0.05
    for axis in (0, 2):
        e = np.zeros(3, np.float32)
        e[axis] = h
        fd = (forward(torch.tensor(base + e))
              - forward(torch.tensor(base - e))) / (2 * h)
        np.testing.assert_allclose(g[axis], fd, rtol=0.2, atol=3e-4)
