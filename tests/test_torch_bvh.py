"""The PyTorch port's BVH path against the JAX package, on the CPU.

Inputs come from numpy seeds. Morton codes, the pool's sort order and the
numpy builder's node arrays are exact. Traces are compared hit by hit: prim
equal, t within 1e-5 relative — the soups are random, so no two triangles
tie. The JAX BVH kernel runs in interpret mode, as the JAX package's own
tests run it (tests/test_pallas_bvh.py); on the CPU the port's wrapper
takes the kernel's plain version. The slice as a whole renders a small
scene forced onto the BVH path under the statistical gate (at most 3% of
pixels off by more than 1e-3, means within 2%).
"""

import os
import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bifrost3d_tpu.apps.scenes import (
    create_sphere_light_scene as jax_sphere_light_scene,
)
from bifrost3d_tpu.geometry import bvh as jbvh
from bifrost3d_tpu.geometry import creation as jcreation
from bifrost3d_tpu.geometry import mesh as jmesh
from bifrost3d_tpu.geometry import pallas_bvh as jhier
from bifrost3d_tpu.geometry import traverse as jtr
from bifrost3d_tpu.integrator import path_tracer as jpt
from bifrost3d_tpu.math import morton as jmorton

from bifrost3d_tpu_torch.apps import scenes as port_scenes
from bifrost3d_tpu_torch.geometry import bvh as tbvh
from bifrost3d_tpu_torch.geometry import creation as tcreation
from bifrost3d_tpu_torch.geometry import mesh as tmesh
from bifrost3d_tpu_torch.geometry import native
from bifrost3d_tpu_torch.geometry import pallas_bvh as thier
from bifrost3d_tpu_torch.geometry import pallas_intersect as tdense
from bifrost3d_tpu_torch.geometry import traverse as ttr
from bifrost3d_tpu_torch.integrator import path_tracer as tpt
from bifrost3d_tpu_torch.math import morton as tmorton
from bifrost3d_tpu_torch.scene import render_scene as trs
from bifrost3d_tpu_torch.scene.camera import camera_from_numpy
from torch_parity import (
    assert_statistical_gate,
    bvh_arrays,
    camera_arrays,
    scene_arrays,
)

N_TRIS = 2000     # four 512-triangle clusters in the JAX packing
R = 512
RES = 32
BOUNCES = 2


def _soup(n, seed):
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-1, 1, size=(n, 1, 3))
    return (centre + rng.normal(scale=0.08, size=(n, 3, 3))).astype(np.float32)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 1.5, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = rng.uniform(0.3, 3.0, size=n).astype(np.float32)
    return o, d, t_max


def _flat(tris):
    flat = tris.reshape(-1, 3)
    return flat, np.arange(flat.shape[0], dtype=np.int32).reshape(-1, 3)


@pytest.fixture(scope="module")
def problem():
    tris = _soup(N_TRIS, 0)
    o, d, t_max = _rays(R, 1)
    jb = jbvh.build_bvh(*_flat(tris))
    return dict(tris=tris, o=o, d=d, t_max=t_max, jbvh=jb,
                jpacked=jhier.pack_hierarchical(tris, jb),
                bvh=tbvh.build_bvh(*_flat(tris)))


def _assert_same_hits(got, ref, rows=slice(None)):
    prim, rprim = got.prim.numpy()[rows], np.asarray(ref.prim)[rows]
    np.testing.assert_array_equal(prim, rprim)
    hit = rprim >= 0
    assert hit.sum() > hit.size // 8
    np.testing.assert_allclose(got.t.numpy()[rows][hit],
                               np.asarray(ref.t)[rows][hit], rtol=1e-5)
    for a, b in ((got.u, ref.u), (got.v, ref.v)):
        np.testing.assert_allclose(a.numpy()[rows][hit],
                                   np.asarray(b)[rows][hit], rtol=1e-4,
                                   atol=1e-5)
    assert np.isinf(got.t.numpy()[rows][~hit]).all()


# -- Morton codes and the pool's sort ---------------------------------------------

def test_morton_codes_are_bit_exact():
    rng = np.random.default_rng(2)
    x, y, z = (rng.integers(0, 2**16, 4096) for _ in range(3))
    tx, ty, tz = (torch.tensor(a) for a in (x, y, z))
    jx, jy, jz = (jnp.asarray(a.astype(np.uint32)) for a in (x, y, z))
    np.testing.assert_array_equal(
        tmorton.morton_encode_3d(tx, ty, tz).numpy().astype(np.uint32),
        np.asarray(jmorton.morton_encode_3d(jx, jy, jz)))
    code = tmorton.morton_encode_2d(tx, ty)
    np.testing.assert_array_equal(code.numpy().astype(np.uint32),
                                  np.asarray(jmorton.morton_encode_2d(jx, jy)))
    back = tmorton.morton_decode_2d(code)
    assert torch.equal(back[0], tx) and torch.equal(back[1], ty)


def test_pool_sort_order_matches_jax():
    """The port's pool order against the JAX pool sort's formula
    (integrator/path_tracer.py:1083-1095) on a seeded pool."""
    rng = np.random.default_rng(3)
    n = 4096
    o = rng.uniform(-3, 5, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    active = rng.uniform(size=n) < 0.7
    lo = np.asarray([-2.0, -1.0, 0.0], np.float32)
    hi = np.asarray([4.0, 3.0, 2.5], np.float32)

    scale = 63.0 / jnp.maximum(jnp.asarray(hi) - jnp.asarray(lo), 1e-20)
    q = jnp.clip((jnp.asarray(o) - lo) * scale, 0.0, 63.0).astype(jnp.uint32)
    m = jmorton.morton_encode_3d(q[:, 0], q[:, 1], q[:, 2])
    jd = jnp.asarray(d)
    octant = ((jd[:, 0] < 0).astype(jnp.uint32) * 4
              + (jd[:, 1] < 0).astype(jnp.uint32) * 2
              + (jd[:, 2] < 0).astype(jnp.uint32))
    key = ((m << jnp.uint32(3)) | octant).astype(jnp.int32)
    key = key + jnp.where(jnp.asarray(active), 0, 1 << 22)
    ref = np.asarray(jnp.argsort(key, stable=True))

    got = tpt.pool_sort_order(torch.tensor(o), torch.tensor(d),
                              torch.tensor(active), torch.tensor(lo),
                              torch.tensor(hi)).numpy()
    np.testing.assert_array_equal(got, ref)
    live = int(active.sum())
    assert active[got[:live]].all() and not active[got[live:]].any()


# -- meshes --------------------------------------------------------------------

def test_torus_and_combine_match_jax():
    ref = jcreation.make_torus(major_segments=12, minor_segments=6)
    got = tcreation.make_torus(major_segments=12, minor_segments=6)
    for field in ("indices", "positions", "normals", "texcoords"):
        np.testing.assert_array_equal(getattr(got, field),
                                      np.asarray(getattr(ref, field)))
    plane = (jcreation.make_plane(2.0)._replace(normals=None),
             tcreation.make_plane(2.0)._replace(normals=None))
    rc = jmesh.combine_meshes([ref, plane[0]])
    gc = tmesh.combine_meshes([got, plane[1]])
    for field in ("indices", "positions", "normals", "texcoords"):
        np.testing.assert_array_equal(getattr(gc, field),
                                      np.asarray(getattr(rc, field)))
    assert gc.tint_roughness is None and gc.indices.dtype == np.int32


def test_torus_grid_mesh_is_the_bench_scene():
    mesh = port_scenes.torus_grid_mesh(2, 8, 4)
    assert mesh.indices.shape == (2 * 2 * 8 * 4 * 2, 3)
    lifts = np.random.default_rng(0).uniform(-1, 1, size=4)
    per = mesh.positions.reshape(4, -1, 3)
    centres = (per.min(axis=1) + per.max(axis=1)) / 2
    np.testing.assert_allclose(centres[:, 1], lifts, atol=1e-6)
    np.testing.assert_allclose(centres[:, [0, 2]],
                               [[-12, -12], [-12, -9], [-9, -12], [-9, -9]],
                               atol=1e-5)


# -- builders ------------------------------------------------------------------

@pytest.mark.parametrize("use_native", [False, True])
def test_build_bvh_matches_jax(problem, use_native):
    if use_native and shutil.which("g++") is None:
        pytest.skip("needs g++ for the native builder")
    tris = problem["tris"][:600]
    ref = jbvh.build_bvh(*_flat(tris), use_native=use_native)
    got = tbvh.build_bvh(*_flat(tris), use_native=use_native)
    for field in ref._fields:
        a = getattr(got, field)
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(ref, field)))
        assert a.dtype == (torch.float32 if field in ("node_min", "node_max")
                           else torch.int32)
    assert got.max_depth == ref.max_depth
    assert got.node_count_total == ref.node_count_total


def test_native_and_numpy_trees_trace_to_the_same_hits(problem):
    if not native.native_available():
        pytest.skip("needs g++ for the native builder")
    tris = torch.tensor(problem["tris"][:600])
    o, d = torch.tensor(problem["o"]), torch.tensor(problem["d"])
    hits = [ttr.intersect_bvh(tbvh.build_bvh(*_flat(tris.numpy()),
                                             use_native=use_native),
                              tris, o, d, 1e-4, float("inf"))
            for use_native in (False, True)]
    assert torch.equal(hits[0].prim, hits[1].prim)
    assert torch.equal(hits[0].t, hits[1].t)
    assert int((hits[0].prim >= 0).sum()) > R // 8


def test_native_builder_builds_into_build_dir():
    if not native.native_available():
        pytest.skip("needs g++ for the native builder")
    path = native.library_path()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path.startswith(os.path.join(repo, "build", "native") + os.sep)
    assert os.path.exists(path)
    assert native.SOURCE == os.path.join(repo, "native", "bvh_builder.cpp")


def test_numpy_builder_runs_where_gxx_is_missing(problem, monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    native._load.cache_clear()
    try:
        tris = problem["tris"][:200]
        with pytest.warns(UserWarning, match="numpy builder runs instead"):
            got = tbvh.build_bvh(*_flat(tris))
        assert not native.native_available()
    finally:
        native._load.cache_clear()
    ref = tbvh.build_bvh(*_flat(tris), use_native=False)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_refit_bvh_matches_jax(problem):
    tris = problem["tris"][:600]
    moved = tris * np.float32(1.5) + np.asarray([0.3, -0.2, 0.1], np.float32)
    ref = jbvh.refit_bvh(jbvh.build_bvh(*_flat(tris)), *_flat(moved))
    got = tbvh.refit_bvh(tbvh.build_bvh(*_flat(tris)), *_flat(moved))
    for field in ref._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)))


def test_tree_deeper_than_the_stack_is_refused(problem, monkeypatch):
    monkeypatch.setattr(tbvh, "STACK_SIZE", 4)
    with pytest.raises(ValueError, match="exceeds the traversal stack"):
        tbvh.build_bvh(*_flat(problem["tris"][:600]))


def test_bvh_carried_from_jax(problem):
    got = tbvh.BVH.from_numpy(bvh_arrays(problem["jbvh"]), device="cpu")
    for a, b in zip(got, problem["bvh"]):
        assert torch.equal(a, b) and a.dtype == b.dtype


# -- traces --------------------------------------------------------------------

@pytest.mark.parametrize("bounded", [False, True])
def test_intersect_bvh_matches_jax(problem, bounded):
    p = problem
    bound = p["t_max"] if bounded else np.inf
    ref = jtr.intersect_bvh(p["jbvh"], jnp.asarray(p["tris"]),
                            jnp.asarray(p["o"]), jnp.asarray(p["d"]), 1e-4,
                            jnp.asarray(bound))
    got = ttr.intersect_bvh(p["bvh"], torch.tensor(p["tris"]),
                            torch.tensor(p["o"]), torch.tensor(p["d"]), 1e-4,
                            torch.tensor(bound))
    _assert_same_hits(got, ref)


def test_intersect_bvh_any_matches_jax(problem):
    p = problem
    ref = jtr.intersect_bvh_any(p["jbvh"], jnp.asarray(p["tris"]),
                                jnp.asarray(p["o"]), jnp.asarray(p["d"]), 1e-4,
                                jnp.asarray(p["t_max"]))
    got = ttr.intersect_bvh_any(p["bvh"], torch.tensor(p["tris"]),
                                torch.tensor(p["o"]), torch.tensor(p["d"]),
                                1e-4, torch.tensor(p["t_max"]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < int(got.sum()) < R


@pytest.fixture(scope="module")
def packed(problem):
    """The port's packing of the tree carried from JAX: both packages trace
    the same BVH."""
    return thier.pack_hierarchical(
        torch.tensor(problem["tris"]),
        tbvh.BVH.from_numpy(bvh_arrays(problem["jbvh"]), device="cpu"))


def test_packing_layout(problem, packed):
    b = problem["bvh"]
    n = b.node_count_total
    assert packed.tri_components.shape == (N_TRIS, 12)
    assert packed.node_boxes.shape == (n, 8) and packed.n_tris == N_TRIS
    assert torch.equal(packed.order, b.prim_indices)
    assert torch.equal(packed.node_boxes[:, :3], b.node_min)
    assert torch.equal(packed.node_boxes[:, 3:6], b.node_max)
    assert torch.equal(packed.node_meta,
                       torch.stack([b.node_a, b.node_count], dim=1))
    tris = torch.tensor(problem["tris"])[b.prim_indices.long()]
    assert torch.equal(packed.tri_components[:, 0:3], tris[:, 0])
    assert torch.equal(packed.tri_components[:, 6:9], tris[:, 2] - tris[:, 0])
    assert bool((packed.tri_components[:, 9:] == 0).all())
    own = thier.pack_hierarchical(problem["tris"])     # builds its own tree
    assert all(torch.equal(a, c) for a, c in zip(own[:3], packed[:3]))


@pytest.mark.parametrize("bounded", [False, True])
def test_hierarchical_intersect_matches_jax_kernel(problem, packed, bounded):
    p = problem
    bound = p["t_max"] if bounded else np.inf
    ref = jhier.hierarchical_intersect(
        p["jpacked"], jnp.asarray(p["o"]), jnp.asarray(p["d"]), 1e-4,
        jnp.asarray(bound), interpret=True)
    before = thier.launch_count
    got = thier.hierarchical_intersect(packed, torch.tensor(p["o"]),
                                       torch.tensor(p["d"]), 1e-4,
                                       torch.tensor(bound))
    assert thier.launch_count == before       # no kernel ran on the CPU
    _assert_same_hits(got, ref)
    assert got.prim.dtype == torch.int32


def test_hierarchical_any_hit_matches_jax_kernel(problem, packed):
    p = problem
    ref = jhier.hierarchical_intersect(
        p["jpacked"], jnp.asarray(p["o"]), jnp.asarray(p["d"]), 1e-4,
        jnp.asarray(p["t_max"]), any_hit=True, interpret=True)
    got = thier.hierarchical_intersect(packed, torch.tensor(p["o"]),
                                       torch.tensor(p["d"]), 1e-4,
                                       torch.tensor(p["t_max"]), any_hit=True)
    np.testing.assert_array_equal(got.prim.numpy() >= 0,
                                  np.asarray(ref.prim) >= 0)
    assert 0 < int((got.prim >= 0).sum()) < R


@pytest.mark.parametrize("as_tensor", [False, True])
def test_hierarchical_live_prefix_matches_jax_kernel(problem, packed,
                                                     as_tensor):
    """JAX skips whole 32-ray groups past the prefix, the port single rays:
    inside the prefix both trace, from the next group boundary both miss."""
    p = problem
    live = jhier.BLOCK_R + 3
    ref = jhier.hierarchical_intersect(
        p["jpacked"], jnp.asarray(p["o"]), jnp.asarray(p["d"]), 1e-4, jnp.inf,
        interpret=True, live_count=jnp.int32(live))
    got = thier.hierarchical_intersect(
        packed, torch.tensor(p["o"]), torch.tensor(p["d"]), 1e-4,
        float("inf"), live_count=torch.tensor(live) if as_tensor else live)
    _assert_same_hits(got, ref, slice(0, live))
    assert bool((got.prim[live:] == -1).all())
    assert bool(torch.isinf(got.t[live:]).all())
    covered = jhier.BLOCK_R + jhier.GROUP_R
    assert (np.asarray(ref.prim)[covered:] == -1).all()


def test_hierarchical_sorted_matches_jax_kernel(problem, packed):
    p = problem
    ref = jhier.hierarchical_intersect_sorted(
        p["jpacked"], jnp.asarray(p["o"]), jnp.asarray(p["d"]), 1e-4,
        jnp.asarray(p["t_max"]), interpret=True)
    got = thier.hierarchical_intersect_sorted(
        packed, torch.tensor(p["o"]), torch.tensor(p["d"]), 1e-4,
        torch.tensor(p["t_max"]))
    _assert_same_hits(got, ref)
    plain = thier.hierarchical_intersect(
        packed, torch.tensor(p["o"]), torch.tensor(p["d"]), 1e-4,
        torch.tensor(p["t_max"]))
    assert torch.equal(got.prim, plain.prim) and torch.equal(got.t, plain.t)


def test_plain_walk_reports_its_work(problem, packed):
    p = problem
    stats = {}
    thier.hierarchical_intersect_reference(
        packed, torch.tensor(p["o"]), torch.tensor(p["d"]), 1e-4,
        float("inf"), stats=stats)
    assert stats["steps"] > 10
    assert int(stats["box_tests"]) >= R
    assert 0 < int(stats["tri_tests"]) <= 4 * int(stats["box_tests"])
    # The distinct records behind those tests: each at most once.
    n_nodes = packed.node_boxes.shape[0]
    assert 0 < int(stats["unique_nodes"]) <= min(n_nodes,
                                                 int(stats["box_tests"]))
    assert 0 < int(stats["unique_tris"]) <= min(N_TRIS,
                                                int(stats["tri_tests"]))
    # The internal nodes entered: the child records a kernel's walk reads.
    assert 0 < int(stats["unique_internal"]) <= min(
        packed.child_records.shape[0] - 1, int(stats["unique_nodes"]))
    # One ray pops each node and enters each leaf at most once.
    one = {}
    thier.hierarchical_intersect_reference(
        packed, torch.tensor(p["o"][:1]), torch.tensor(p["d"][:1]), 1e-4,
        float("inf"), stats=one)
    assert int(one["unique_nodes"]) == int(one["box_tests"])
    assert int(one["unique_tris"]) == int(one["tri_tests"])


def test_scene_dispatch(problem, packed):
    p = problem
    tris, o, d = (torch.tensor(p[k]) for k in ("tris", "o", "d"))
    by_bvh = ttr.intersect_scene(p["bvh"], tris, o, d)
    by_packing = ttr.intersect_scene(None, tris, o, d, tri_clustered=packed)
    by_table = ttr.intersect_scene(
        None, tris, o, d, tri_components=tdense.pack_triangles(tris)[0])
    by_brute = ttr.intersect_scene(None, tris, o, d)
    for other in (by_packing, by_table, by_brute):
        assert torch.equal(other.prim, by_bvh.prim)
        torch.testing.assert_close(other.t, by_bvh.t, rtol=1e-5, atol=0.0)
    occluded = ttr.intersect_scene_any(None, tris, o, d, tri_clustered=packed,
                                       live_count=100)
    assert torch.equal(occluded[:100], by_bvh.prim[:100] >= 0)
    assert not bool(occluded[100:].any())
    meta = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="meta"):
        ttr.intersect_scene(None, tris, meta, meta, tri_clustered=packed)


def test_kernel_wrapper_refuses_a_tree_deeper_than_its_stack(problem, packed):
    """A packing made by hand is checked like one that pack_hierarchical
    made: the kernel's private stack holds STACK_SIZE entries."""
    assert packed.max_depth == problem["bvh"].max_depth
    o, d = torch.tensor(problem["o"]), torch.tensor(problem["d"])
    deep = packed._replace(max_depth=tbvh.STACK_SIZE)
    with pytest.raises(ValueError, match="exceeds the kernel stack"):
        thier.hierarchical_intersect_cuda(deep, o, d, 1e-4, float("inf"))


def test_packing_refuses_a_foreign_tree(problem):
    with pytest.raises(ValueError, match="orders 2000"):
        thier.pack_hierarchical(problem["tris"][:100], problem["bvh"])


# -- the slice as a whole ----------------------------------------------------------

@pytest.fixture(scope="module")
def jax_sphere_light():
    scene, cam = jax_sphere_light_scene()
    settings = jpt.settings_for_scene(scene, max_bounce_count=BOUNCES)
    ref = np.asarray(jpt.render_sample_pooled(scene, cam, RES, RES,
                                              jnp.uint32(1), settings))
    return scene, cam, ref


@pytest.fixture
def forced_bvh_scene(jax_sphere_light, monkeypatch):
    """The JAX SphereLight scene (960 triangles) carried across with its
    BVH, with the port's dense limit lowered so that it packs for and
    traces through the BVH path."""
    jscene, jcam, _ = jax_sphere_light
    monkeypatch.setattr(ttr, "PALLAS_MAX_TRIS", 100)
    scene = trs.render_scene_from_numpy(scene_arrays(jscene), device="cpu")
    return scene, camera_from_numpy(camera_arrays(jcam), device="cpu")


def test_forced_bvh_path_matches_jax_render(jax_sphere_light, forced_bvh_scene):
    scene, cam = forced_bvh_scene
    assert scene.tri_clustered is not None and scene.bvh is not None
    assert scene.tri_clustered.n_tris == 960
    settings = tpt.settings_for_scene(scene, max_bounce_count=BOUNCES)
    assert settings.sort_rays_every == 1
    path = tpt.explain_render_path(scene, settings)
    assert path.startswith("wavefront [BVH trace, pool sorted every 1 step(s)]")
    img = tpt.render_sample_fast(scene, cam, RES, RES, 1, settings).numpy()
    assert img.mean() > 0.01
    assert_statistical_gate(img, jax_sphere_light[2])


def test_forced_bvh_path_matches_dense_path(jax_sphere_light, forced_bvh_scene,
                                            monkeypatch):
    scene, cam = forced_bvh_scene
    settings = tpt.settings_for_scene(scene, max_bounce_count=BOUNCES)
    img = tpt.render_sample_pooled(scene, cam, RES, RES, 2, settings,
                                   pool_size=256)
    monkeypatch.setattr(ttr, "PALLAS_MAX_TRIS", 65536)
    dense = trs.render_scene_from_numpy(scene_arrays(jax_sphere_light[0]),
                                        device="cpu")
    assert dense.tri_clustered is None and dense.tri_components is not None
    dense_settings = tpt.settings_for_scene(dense, max_bounce_count=BOUNCES)
    assert dense_settings.sort_rays_every == 0
    assert tpt.explain_render_path(dense).startswith("wavefront: ")
    ref = tpt.render_sample_pooled(dense, cam, RES, RES, 2, dense_settings,
                                   pool_size=256)
    assert_statistical_gate(img.numpy(), ref.numpy())


def test_sorting_needs_the_bvh(forced_bvh_scene):
    scene, cam = forced_bvh_scene
    settings = tpt.settings_for_scene(scene, max_bounce_count=1)
    with pytest.raises(ValueError, match="carries its BVH"):
        tpt.render_sample_pooled(scene._replace(bvh=None), cam, 8, 8, 0,
                                 settings)
    unsorted = settings._replace(sort_rays_every=0)
    assert tpt.explain_render_path(scene, unsorted).startswith(
        "wavefront [BVH trace, pool not sorted]: ")
    img = tpt.render_sample_pooled(scene._replace(bvh=None), cam, 8, 8, 0,
                                   unsorted)
    assert bool(torch.isfinite(img).all())


def test_torus_grid_scene_packs_for_the_bvh_kernel(monkeypatch):
    monkeypatch.setattr(ttr, "PALLAS_MAX_TRIS", 100)
    scene, cam = port_scenes.TEST_SCENES["torus_grid"](
        grid=2, major_segments=8, minor_segments=4, device="cpu")
    assert scene.tri_verts.shape[0] == 256 and scene.tri_components is None
    assert scene.tri_clustered.n_tris == 256
    assert scene.lights.count == 1
    np.testing.assert_array_equal(cam.transform.translation.numpy(),
                                  port_scenes.TORUS_GRID_EYE)


def test_refit_render_scene_follows_a_moved_instance(monkeypatch):
    monkeypatch.setattr(ttr, "PALLAS_MAX_TRIS", 100)
    mesh = tcreation.make_torus(major_segments=12, minor_segments=6)
    plane = tcreation.make_plane(size=6.0)
    from bifrost3d_tpu_torch.lights.types import LightArray
    from bifrost3d_tpu_torch.scene.materials import MaterialArray, dielectric
    mats = MaterialArray.build([dielectric((0.7, 0.7, 0.7), 0.5)], device="cpu")
    lights = LightArray.build([], device="cpu")

    def instances(x):
        return [(plane, 0, port_scenes._trs((0, -0.5, 0))),
                (mesh, 0, port_scenes._trs((x, 0.5, 0)))]

    scene = trs.build_render_scene(instances(0.0), mats, lights, device="cpu")
    moved = trs.refit_render_scene(scene, instances(1.0))
    fresh = trs.build_render_scene(instances(1.0), mats, lights, device="cpu")
    assert torch.equal(moved.bvh.node_a, scene.bvh.node_a)     # same topology
    assert torch.equal(moved.tri_verts, fresh.tri_verts)
    assert moved.materials is scene.materials
    o = torch.tensor([[1.0, 3.0, 0.9], [0.0, 3.0, 0.9], [1.0, 3.0, 0.0]])
    d = torch.tensor([[0.0, -1.0, 0.0]] * 3)
    got = ttr.intersect_scene(moved.bvh, moved.tri_verts, o, d,
                              tri_clustered=moved.tri_clustered)
    ref = ttr.intersect_scene(fresh.bvh, fresh.tri_verts, o, d,
                              tri_clustered=fresh.tri_clustered)
    assert torch.equal(got.prim, ref.prim)
    torch.testing.assert_close(got.t, ref.t, rtol=1e-5, atol=0.0)
    assert got.t[0] < 2.4 < got.t[1]     # the torus moved under ray 0
    with pytest.raises(ValueError, match="identical instance topology"):
        trs.refit_render_scene(scene, instances(1.0)[:1])
