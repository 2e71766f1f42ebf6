"""The PyTorch port's resident-cluster BVH trace against the JAX package, on
the CPU.

Inputs come from numpy seeds. The packings are compared array by array
(exactly: both packages construct the same trees from the same soup). The JAX
kernel ``vmem_intersect`` runs in Pallas interpret mode, as
tests/test_pallas_bvh.py::TestVmemIntersect runs it; on CPU tensors the
port's wrapper takes the kernel's plain version, the group walk written
out. Hits are compared one by one: prim equal, t within 1e-5 relative, u
and v within 1e-4 relative or 1e-5 absolute (differences of products that
XLA and PyTorch contract differently); the soups are random, so no two
triangles tie. Both are also held against brute force.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bifrost3d_tpu.geometry import bvh as jbvh
from bifrost3d_tpu.geometry import pallas_bvh_vmem as jvm
from bifrost3d_tpu.geometry import traverse as jtr

from bifrost3d_tpu_torch.geometry import bvh as tbvh
from bifrost3d_tpu_torch.geometry import pallas_bvh_vmem as tvm
from bifrost3d_tpu_torch.geometry import traverse as ttr
from torch_parity import bvh_arrays, packing_arrays

N_TRIS = 3000     # six clusters, the last one partly filled: 11 nodes
R = 4 * jvm.BLOCK_R + 13    # the last group partly filled


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
    return dict(tris=tris, o=o, d=d, t_max=t_max,
                jpacked=jvm.pack_vmem(tris, jb),
                packed=tvm.pack_vmem(torch.tensor(tris), tbvh.BVH.from_numpy(
                    bvh_arrays(jb), device="cpu")))


def _torch_rays(p):
    return torch.tensor(p["o"]), torch.tensor(p["d"])


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


def test_packing_matches_jax(problem):
    packed, jpacked = problem["packed"], problem["jpacked"]
    n_clusters = -(-N_TRIS // tvm.CLUSTER_T)
    n_nodes = 2 * n_clusters - 1
    assert packed.n_tris == int(jpacked.n_tris) == N_TRIS
    assert packed.node_boxes.shape == (n_nodes, 8)
    assert packed.node_meta.shape == (n_nodes,)
    np.testing.assert_array_equal(packed.tri_planes.numpy(),
                                  np.asarray(jpacked.tri_planes))
    np.testing.assert_array_equal(packed.order.numpy(),
                                  np.asarray(jpacked.order))
    np.testing.assert_array_equal(packed.node_boxes[:, :6].numpy(),
                                  np.asarray(jpacked.node_boxes)[:n_nodes, :6])
    np.testing.assert_array_equal(packed.node_meta.numpy(),
                                  np.asarray(jpacked.node_meta)[:n_nodes])
    assert packed.node_meta.dtype == packed.order.dtype == torch.int32
    # Every cluster is the leaf of exactly one node.
    leaves = -packed.node_meta[packed.node_meta < 0] - 1
    assert sorted(leaves.tolist()) == list(range(n_clusters))
    assert 1 < packed.max_depth <= n_clusters


def test_packing_builds_its_own_tree_and_carries_jax_packing(problem):
    own = tvm.pack_vmem(problem["tris"])               # numpy in, tree built
    carried = tvm.VmemTriangles.from_numpy(packing_arrays(problem["jpacked"]),
                                        device="cpu")
    for other in (own, carried):
        for a, b in zip(other[:4], problem["packed"][:4]):
            assert torch.equal(a, b) and a.dtype == b.dtype
        assert other[4:] == problem["packed"][4:]      # n_tris, max_depth


@pytest.mark.parametrize("n", [0, 1, 512, 513, 196608, 196609, 262144])
def test_fits_vmem_matches_jax(n):
    """12 MiB at 64 bytes per padded slot: 196,608 triangles fit, one more
    does not."""
    assert tvm.fits_vmem(n) == jvm.fits_vmem(n)
    assert tvm.fits_vmem(n) == (n <= 196608)
    assert tvm.VMEM_TRI_BYTES == jvm.VMEM_TRI_BYTES


@pytest.mark.parametrize("bounded", [False, True])
def test_plain_version_matches_jax_kernel(problem, bounded):
    p = problem
    bound = p["t_max"] if bounded else np.float32(np.inf)
    ref = jvm.vmem_intersect(p["jpacked"], jnp.asarray(p["o"]),
                             jnp.asarray(p["d"]), 1e-4, jnp.asarray(bound),
                             interpret=True)
    before = tvm.launch_count
    got = tvm.vmem_intersect(p["packed"], *_torch_rays(p), 1e-4,
                             torch.tensor(bound))
    assert tvm.launch_count == before         # no kernel ran on the CPU
    _assert_same_hits(got, ref)
    assert got.prim.dtype == torch.int32
    brute = jtr.intersect_triangles_brute(
        jnp.asarray(p["tris"]), jnp.asarray(p["o"]), jnp.asarray(p["d"]),
        1e-4, jnp.asarray(bound))
    _assert_same_hits(got, brute)


def test_any_hit_matches_jax_kernel(problem):
    p = problem
    ref = jvm.vmem_intersect(p["jpacked"], jnp.asarray(p["o"]),
                             jnp.asarray(p["d"]), 1e-4,
                             jnp.asarray(p["t_max"]), any_hit=True,
                             interpret=True)
    got = tvm.vmem_intersect(p["packed"], *_torch_rays(p), 1e-4,
                             torch.tensor(p["t_max"]), any_hit=True)
    np.testing.assert_array_equal(got.prim.numpy() >= 0,
                                  np.asarray(ref.prim) >= 0)
    closest = tvm.vmem_intersect(p["packed"], *_torch_rays(p), 1e-4,
                                 torch.tensor(p["t_max"]))
    assert torch.equal(got.prim >= 0, closest.prim >= 0)
    assert 0 < int((got.prim >= 0).sum()) < R


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("live", [jvm.BLOCK_R, jvm.BLOCK_R + 3])
def test_live_prefix_matches_jax_kernel(problem, live, as_tensor):
    """Whole 32-ray groups that start past the prefix miss untraversed, in
    both packages; the group the prefix ends in is traced to its end."""
    p = problem
    ref = jvm.vmem_intersect(p["jpacked"], jnp.asarray(p["o"]),
                             jnp.asarray(p["d"]), 1e-4, jnp.inf,
                             interpret=True, live_count=jnp.int32(live))
    got = tvm.vmem_intersect(
        p["packed"], *_torch_rays(p), 1e-4, float("inf"),
        live_count=torch.tensor(live) if as_tensor else live)
    covered = -(-live // tvm.GROUP_R) * tvm.GROUP_R
    _assert_same_hits(got, ref, slice(0, covered))
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(ref.prim))
    assert bool((got.prim[covered:] == -1).all())
    assert bool(torch.isinf(got.t[covered:]).all())


def test_plain_walk_reports_its_work(problem):
    p = problem
    stats = {}
    tvm.vmem_intersect_reference(p["packed"], *_torch_rays(p), 1e-4,
                                 float("inf"), stats=stats)
    n_groups = -(-R // tvm.GROUP_R)
    n_nodes = p["packed"].node_meta.shape[0]
    n_clusters = -(-N_TRIS // tvm.CLUSTER_T)
    assert stats["steps"] >= 3
    assert n_groups <= stats["probes"] <= 2 * n_groups * n_nodes
    assert 0 < stats["leaf_tests"] <= n_groups * n_clusters
    assert 0 < stats["nodes_read"] <= n_nodes
    assert 0 < stats["clusters_read"] <= n_clusters


def test_scene_dispatch_takes_the_resident_walk(problem, monkeypatch):
    p = problem
    o, d = _torch_rays(p)
    tris = torch.tensor(p["tris"])
    calls = []
    walk = tvm.vmem_intersect
    monkeypatch.setattr(tvm, "vmem_intersect",
                        lambda *a, **k: calls.append(k) or walk(*a, **k))
    got = ttr.intersect_scene(None, tris, o, d, tri_clustered=p["packed"])
    brute = ttr.intersect_scene(None, tris, o, d)
    assert torch.equal(got.prim, brute.prim)
    torch.testing.assert_close(got.t, brute.t, rtol=1e-5, atol=0.0)
    occluded = ttr.intersect_scene_any(None, tris, o, d,
                                       tri_clustered=p["packed"],
                                       live_count=96)
    assert torch.equal(occluded[:96], brute.prim[:96] >= 0)
    assert not bool(occluded[96:].any())
    assert [c["any_hit"] for c in calls] == [False, True]
    assert calls[1]["live_count"] == 96


def test_kernel_wrapper_checks_its_tables(problem):
    packed = problem["packed"]
    o, d = (torch.tensor(a) for a in _rays(8, 4)[:2])
    deep = packed._replace(max_depth=tbvh.STACK_SIZE)
    with pytest.raises(ValueError, match="exceeds the kernel stack"):
        tvm.vmem_intersect_cuda(deep, o, d, 1e-4, 1.0)
    with pytest.raises(ValueError, match="exceeds the packed table"):
        tvm.vmem_intersect_cuda(packed._replace(n_tris=3073), o, d, 1e-4, 1.0)
    with pytest.raises(ValueError, match="node_meta"):
        tvm.vmem_intersect_cuda(
            packed._replace(node_meta=packed.node_meta[:3]), o, d, 1e-4, 1.0)


def test_packing_refuses_a_tree_deeper_than_the_stack(problem, monkeypatch):
    monkeypatch.setattr(tvm, "STACK_SIZE", 2)
    with pytest.raises(ValueError, match="exceeds the kernel stack"):
        tvm.pack_vmem(problem["tris"])
