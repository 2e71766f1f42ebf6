"""The PyTorch port's cluster-scan trace against the JAX package, on the CPU.

Inputs come from numpy seeds. The packings are compared array by array
(exactly: both packages construct the same tree from the same soup). The JAX
kernel ``clustered_intersect`` runs in Pallas interpret mode; on CPU
tensors the port's wrapper takes the kernel's plain version. Hits are
compared one by one: prim equal, t within 1e-5 relative, u and v within
1e-4 relative or 1e-5 absolute (a barycentric of a triangle three units
from the eye is a difference of products that XLA and PyTorch contract
differently); the soups are random, so no two triangles tie. Both are also
held against brute force.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bifrost3d_tpu.geometry import bvh as jbvh
from bifrost3d_tpu.geometry import pallas_clustered as jcl
from bifrost3d_tpu.geometry import traverse as jtr

from bifrost3d_tpu_torch.apps import scenes as port_scenes
from bifrost3d_tpu_torch.geometry import bvh as tbvh
from bifrost3d_tpu_torch.geometry import pallas_bvh as thier
from bifrost3d_tpu_torch.geometry import pallas_bvh_vmem as tvm
from bifrost3d_tpu_torch.geometry import pallas_clustered as tcl
from bifrost3d_tpu_torch.geometry import traverse as ttr
from bifrost3d_tpu_torch.integrator import path_tracer as tpt
from torch_parity import assert_statistical_gate, bvh_arrays, packing_arrays

N_TRIS = 2000     # four clusters, the last one partly filled
R = 600           # three ray blocks, the last one partly filled


def _soup(n, seed):
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-1, 1, size=(n, 1, 3))
    return (centre + rng.normal(scale=0.08, size=(n, 3, 3))).astype(np.float32)


def _random_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 1.5, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _camera_rays(n):
    """Rays of one eye through a narrow window: a block of 256 neighbours
    passes few of the clusters' boxes."""
    side = int(np.ceil(np.sqrt(n)))
    xs, ys = np.meshgrid(np.linspace(-0.25, 0.25, side),
                         np.linspace(-0.25, 0.25, side))
    d = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3)[:n]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o = np.broadcast_to(np.asarray([0.3, -0.2, -3.0], np.float32),
                        d.shape).copy()
    return o, d


_RAY_SETS = {"random": lambda: _random_rays(R, 1), "camera": lambda: _camera_rays(R)}


def _flat(tris):
    flat = tris.reshape(-1, 3)
    return flat, np.arange(flat.shape[0], dtype=np.int32).reshape(-1, 3)


@pytest.fixture(scope="module")
def problem():
    tris = _soup(N_TRIS, 0)
    jb = jbvh.build_bvh(*_flat(tris))
    jpacked = jcl.pack_clustered(tris, jb)
    return dict(tris=tris, jpacked=jpacked,
                packed=tcl.pack_clustered(
                    torch.tensor(tris),
                    tbvh.BVH.from_numpy(bvh_arrays(jb), device="cpu")))


def _assert_same_hits(got, ref):
    prim, rprim = got.prim.numpy(), np.asarray(ref.prim)
    np.testing.assert_array_equal(prim, rprim)
    hit = rprim >= 0
    assert hit.sum() > hit.size // 8
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=1e-5)
    for a, b in ((got.u, ref.u), (got.v, ref.v)):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit],
                                   rtol=1e-4, atol=1e-5)
    assert np.isinf(got.t.numpy()[~hit]).all()


def test_packing_matches_jax(problem):
    packed, jpacked = problem["packed"], problem["jpacked"]
    n_clusters = (N_TRIS + tcl.CLUSTER_T - 1) // tcl.CLUSTER_T
    assert packed.n_tris == int(jpacked.n_tris) == N_TRIS
    assert packed.cluster_boxes.shape == (n_clusters, 8)
    np.testing.assert_array_equal(packed.tri_components.numpy(),
                                  np.asarray(jpacked.tri_components))
    np.testing.assert_array_equal(packed.order.numpy(),
                                  np.asarray(jpacked.order))
    np.testing.assert_array_equal(
        packed.cluster_boxes[:, :6].numpy(),
        np.asarray(jpacked.cluster_boxes)[:n_clusters, :6])
    assert bool((packed.cluster_boxes[:, 6:] == 0).all())
    assert packed.order.dtype == torch.int32
    # JAX's padding clusters can never pass a ray; the port has none.
    assert (np.asarray(jpacked.cluster_boxes)[n_clusters:, 0] > 1e38).all()


def test_packing_builds_its_own_tree_and_carries_jax_packing(problem):
    own = tcl.pack_clustered(problem["tris"])          # numpy in, tree built
    carried = tcl.ClusteredTriangles.from_numpy(
        packing_arrays(problem["jpacked"]), device="cpu")
    for other in (own, carried):
        for a, b in zip(other[:3], problem["packed"][:3]):
            assert torch.equal(a, b) and a.dtype == b.dtype
        assert other.n_tris == N_TRIS
    with pytest.raises(ValueError, match="orders 2000"):
        tcl.pack_clustered(problem["tris"][:100],
                           tbvh.build_bvh(*_flat(problem["tris"])))


@pytest.mark.parametrize("rays", sorted(_RAY_SETS))
@pytest.mark.parametrize("bounded", [False, True])
def test_plain_version_matches_jax_kernel(problem, rays, bounded):
    o, d = _RAY_SETS[rays]()
    bound = (np.random.default_rng(2).uniform(0.5, 4.0, R).astype(np.float32)
             if bounded else np.float32(np.inf))
    ref = jcl.clustered_intersect(problem["jpacked"], jnp.asarray(o),
                                  jnp.asarray(d), 1e-4, jnp.asarray(bound),
                                  interpret=True)
    before = tcl.launch_count
    got = tcl.clustered_intersect(problem["packed"], torch.tensor(o),
                                  torch.tensor(d), 1e-4, torch.tensor(bound))
    assert tcl.launch_count == before        # no kernel ran on the CPU
    _assert_same_hits(got, ref)
    assert got.prim.dtype == torch.int32
    brute = jtr.intersect_triangles_brute(
        jnp.asarray(problem["tris"]), jnp.asarray(o), jnp.asarray(d), 1e-4,
        jnp.asarray(bound))
    _assert_same_hits(got, brute)


def test_scan_culls_clusters_for_coherent_rays(problem):
    """The plain version reports its work: camera rays fetch fewer (block,
    cluster) pairs than every block × every cluster, random rays nearly
    all; a cluster is read at most once per block."""
    n_clusters = problem["packed"].cluster_boxes.shape[0]
    n_blocks = -(-R // tcl.BLOCK_R)
    fetched = {}
    for name, make in _RAY_SETS.items():
        o, d = make()
        stats = {}
        tcl.clustered_intersect_reference(problem["packed"], torch.tensor(o),
                                          torch.tensor(d), 1e-4, float("inf"),
                                          stats=stats)
        assert 0 < stats["fetches"] <= n_blocks * n_clusters
        assert 0 < stats["clusters_read"] <= n_clusters
        fetched[name] = stats["fetches"]
    assert fetched["camera"] < n_blocks * n_clusters
    assert fetched["camera"] <= fetched["random"]


def test_scene_dispatch_takes_the_cluster_scan(problem, monkeypatch):
    """intersect_scene sends a ClusteredTriangles packing to the scan,
    which has no any-hit mode and no live prefix: occlusion is the closest
    hit's, and rays past ``live_count`` are traced all the same."""
    o, d = _random_rays(R, 3)
    o, d = torch.tensor(o), torch.tensor(d)
    tris = torch.tensor(problem["tris"])
    calls = []
    scan = tcl.clustered_intersect
    monkeypatch.setattr(tcl, "clustered_intersect",
                        lambda *a, **k: calls.append(1) or scan(*a, **k))
    got = ttr.intersect_scene(None, tris, o, d,
                              tri_clustered=problem["packed"])
    brute = ttr.intersect_scene(None, tris, o, d)
    assert calls == [1]
    assert torch.equal(got.prim, brute.prim)
    torch.testing.assert_close(got.t, brute.t, rtol=1e-5, atol=0.0)
    occluded = ttr.intersect_scene_any(None, tris, o, d,
                                       tri_clustered=problem["packed"],
                                       live_count=100)
    assert torch.equal(occluded, brute.prim >= 0)
    meta = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="meta"):
        ttr.intersect_scene(None, tris, meta, meta,
                            tri_clustered=problem["packed"])


def test_kernel_wrapper_checks_its_tables(problem):
    packed = problem["packed"]
    o, d = (torch.tensor(a) for a in _random_rays(8, 4))
    with pytest.raises(ValueError, match="cluster_boxes must be"):
        tcl.clustered_intersect_cuda(
            packed._replace(cluster_boxes=packed.cluster_boxes[:2]), o, d,
            1e-4, 1.0)
    with pytest.raises(ValueError, match="exceeds the packed table"):
        tcl.clustered_intersect_cuda(packed._replace(n_tris=4096), o, d,
                                     1e-4, 1.0)
    with pytest.raises(ValueError, match=r"must both be \[r, 3\]"):
        tcl.clustered_intersect_cuda(packed, o[:, :2], d, 1e-4, 1.0)


# -- whole frames ------------------------------------------------------------------

@pytest.fixture(scope="module")
def coated_frame():
    """The port's coated scene (236 triangles) at 32², 2 bounces through
    the pooled wavefront with the dense trace."""
    scene, cam = port_scenes.TEST_SCENES["coated"](device="cpu")
    settings = tpt.settings_for_scene(scene, max_bounce_count=2)
    assert scene.tri_clustered is None and scene.tri_components is not None
    return scene, cam, tpt.render_sample_pooled(scene, cam, 32, 32, 1,
                                                settings).numpy()


@pytest.mark.parametrize("packing", ["clustered", "vmem", "hier"])
def test_wavefront_frame_with_each_packing_matches_dense(coated_frame,
                                                         monkeypatch, packing):
    """``scene._replace(tri_clustered=pack_...)`` puts a scene on another
    trace; the frame passes the statistical gate (3% of pixels off by
    > 1e-3, means within 2%) against the dense trace's."""
    scene, cam, ref = coated_frame
    module, pack, entry = {
        "clustered": (tcl, tcl.pack_clustered, "clustered_intersect"),
        "vmem": (tvm, tvm.pack_vmem, "vmem_intersect"),
        "hier": (thier, thier.pack_hierarchical, "hierarchical_intersect"),
    }[packing]
    packed = scene._replace(tri_clustered=pack(scene.tri_verts, scene.bvh),
                            tri_components=None)
    calls = []
    trace = getattr(module, entry)
    monkeypatch.setattr(module, entry,
                        lambda *a, **k: calls.append(1) or trace(*a, **k))
    settings = tpt.settings_for_scene(packed, max_bounce_count=2)
    kind = {"clustered": "cluster-scan", "vmem": "resident-cluster",
            "hier": "BVH"}[packing]
    assert tpt.explain_render_path(packed, settings) == (
        f"wavefront [{kind} trace, pool sorted every 1 step(s)]: device is "
        "cpu, not cuda")
    img = tpt.render_sample_pooled(packed, cam, 32, 32, 1, settings)
    assert len(calls) >= 2            # closest and shadow rays, every step
    assert_statistical_gate(img.numpy(), ref)
    assert img.mean() > 0.01
