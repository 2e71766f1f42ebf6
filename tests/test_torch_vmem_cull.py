"""The resident-cluster walk's leaf cull (B7), on the CPU: the plain model
of the CUDA kernel's leaf test (``vmem_intersect_reference(...,
culled=True)``) against the plain walk, whose full leaf test the JAX
package's kernel makes, and against that kernel in Pallas interpret mode.

Inputs come from numpy seeds: a random soup of 2,600 triangles (six
clusters, the last one partly filled) and 2,061 camera or incoherent rays
(the last 32-ray group partly filled). Against the plain walk the hits,
closest and any-hit, are compared bit for bit (the cull skips only
triangles no ray would take). Against JAX:
prim equal; t within rtol 1e-5; u, v within rtol 1e-4, atol 1e-5 (a
barycentric is a difference of products that XLA and PyTorch contract
differently).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bifrost3d_tpu.geometry import bvh as jbvh
from bifrost3d_tpu.geometry import pallas_bvh_vmem as jvm

from bifrost3d_tpu_torch.geometry import bvh as tbvh
from bifrost3d_tpu_torch.geometry import pallas_bvh_vmem as tvm
from bifrost3d_tpu_torch.geometry import pallas_intersect as tpi
from torch_parity import bvh_arrays

N_TRIS = 2600
R = 64 * tvm.GROUP_R + 13
R_JAX = 4 * jvm.BLOCK_R + 13   # JAX's interpret mode takes ~10 ms a ray
LIVE = 20 * tvm.GROUP_R + 5    # inside a group: that group is traced whole
RAYS = ("camera", "incoherent")


def _soup(n, seed):
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-1, 1, size=(n, 1, 3))
    return (centre + rng.normal(scale=0.08, size=(n, 3, 3))).astype(np.float32)


def _ray_set(name):
    """→ (origin, direction, t_max) numpy arrays of R rays."""
    rng = np.random.default_rng(2 if name == "camera" else 3)
    if name == "camera":
        # A pinhole 3 units in front of the soup, rows of 46 pixels: a
        # group of 32 is a row segment.
        side = 46
        xs, ys = np.meshgrid(np.linspace(-0.5, 0.5, side),
                             np.linspace(-0.5, 0.5, side))
        d = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3)[:R]
        o = np.broadcast_to(np.asarray([0.1, -0.1, -3.0]), d.shape)
    else:
        o = rng.uniform(-1.5, 1.5, size=(R, 3))
        d = rng.normal(size=(R, 3))
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = rng.uniform(0.5, 4.0, size=R)
    return [np.ascontiguousarray(a, dtype=np.float32) for a in (o, d, t_max)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain walks here are thousands of small ops; on one thread they
    do not wait on the cores that the other test processes hold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def problem():
    tris = _soup(N_TRIS, 0)
    flat = tris.reshape(-1, 3)
    jb = jbvh.build_bvh(flat, np.arange(flat.shape[0], dtype=np.int32)
                        .reshape(-1, 3))
    return dict(tris=tris, jpacked=jvm.pack_vmem(tris, jb),
                packed=tvm.pack_vmem(torch.tensor(tris), tbvh.BVH.from_numpy(
                    bvh_arrays(jb), device="cpu")),
                rays={name: _ray_set(name) for name in RAYS})


def _walk(p, rays, bounded, **kw):
    o, d, t_max = p["rays"][rays]
    bound = torch.tensor(t_max) if bounded else float("inf")
    return tvm.vmem_intersect_reference(p["packed"], torch.tensor(o),
                                        torch.tensor(d), 1e-4, bound, **kw)


def _assert_bit_equal(got, ref):
    assert torch.equal(got.prim, ref.prim)
    for a, b in ((got.t, ref.t), (got.u, ref.u), (got.v, ref.v)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("rays", RAYS)
def test_culled_model_is_the_plain_walk_bit_for_bit(problem, rays, bounded):
    """Closest hit: prim on every ray and t, u, v bit for bit are the
    plain walk's full leaf test's, so every later probe, push and tie is
    too (the walk's step, probe and leaf counts agree)."""
    walk, model = {}, {}
    ref = _walk(problem, rays, bounded, stats=walk)
    got = _walk(problem, rays, bounded, stats=model, culled=True)
    _assert_bit_equal(got, ref)
    assert R // 8 < int((ref.prim >= 0).sum()) < R
    for key in ("steps", "probes", "leaf_tests", "nodes_read",
                "clusters_read"):
        assert model[key] == walk[key], key


@pytest.mark.parametrize("rays", RAYS)
def test_culled_any_hit_is_the_plain_walks(problem, rays):
    """Any-hit: the hits of the plain walk bit for bit (the nearest of the
    first leaf hit, frozen at t_min), so the rays occluded are those the
    closest hit within t_max finds; with no more tests than closest
    hit's."""
    ref = _walk(problem, rays, True, any_hit=True)
    any_stats, closest_stats = {}, {}
    got = _walk(problem, rays, True, any_hit=True, culled=True,
                stats=any_stats)
    closest = _walk(problem, rays, True, culled=True, stats=closest_stats)
    _assert_bit_equal(got, ref)
    assert torch.equal(got.prim >= 0, closest.prim >= 0)
    hit = got.prim >= 0
    assert 0 < int(hit.sum()) < R
    assert bool((got.t[hit] == np.float32(1e-4)).all())
    assert any_stats["tri_tests"] <= closest_stats["tri_tests"]


@pytest.mark.parametrize("form", ["int", "int32", "int64"])
def test_culled_model_honours_the_live_prefix(problem, form):
    """Groups that start at or past the live count miss untraversed; the
    group the count ends in is traced whole, as by the plain walk."""
    live = {"int": LIVE,
            "int32": torch.tensor(LIVE, dtype=torch.int32),
            "int64": torch.tensor(LIVE)}[form]
    ref = _walk(problem, "incoherent", False, live_count=LIVE)
    got = _walk(problem, "incoherent", False, live_count=live, culled=True)
    _assert_bit_equal(got, ref)
    covered = -(-LIVE // tvm.GROUP_R) * tvm.GROUP_R
    assert bool((got.prim[covered:] == -1).all())
    assert bool(torch.isinf(got.t[covered:]).all())
    assert int((got.prim[:covered] >= 0).sum()) > covered // 8


@pytest.mark.parametrize("rays", RAYS)
def test_culled_model_counts_less_work_than_the_full_leaf_test(problem, rays):
    stats = {}
    _walk(problem, rays, False, stats=stats, culled=True)
    n_chunks = -(-N_TRIS // tpi.CHUNK)
    full = tvm.GROUP_R * tvm.CLUSTER_T * stats["leaf_tests"]
    assert 0 < stats["cluster_tests"] <= tvm.GROUP_R * stats["leaf_tests"]
    assert 0 < stats["box_tests"] <= tpi.GROUP_CHUNKS * stats["cluster_tests"]
    assert 0 < stats["tri_tests"] < full // 4
    assert 0 < stats["chunks_read"] <= n_chunks


def test_cluster_boxes_are_the_union_of_their_chunk_boxes(problem):
    """The model's padded cluster boxes are the group boxes of
    culled_dense_intersect_reference: each cluster's 16 padded chunk boxes
    merged, so each holds its triangles with the padding to spare."""
    comp = problem["packed"].tri_planes.reshape(16, -1)
    rows, (lo, hi), (c_lo, c_hi) = tvm._cull_tables(comp, N_TRIS)
    assert rows.shape == (N_TRIS, 9)
    n_clusters = -(-N_TRIS // tvm.CLUSTER_T)
    assert c_lo.shape == c_hi.shape == (n_clusters, 3)
    for c in range(n_clusters):
        g = slice(c * tpi.GROUP_CHUNKS, (c + 1) * tpi.GROUP_CHUNKS)
        assert torch.equal(c_lo[c], lo[g].amin(dim=0))
        assert torch.equal(c_hi[c], hi[g].amax(dim=0))
        tri = torch.tensor(problem["tris"])[
            problem["packed"].order[c * tvm.CLUSTER_T:
                                    min(N_TRIS, (c + 1) * tvm.CLUSTER_T)]
            .long()].reshape(-1, 3)
        assert bool((c_lo[c] < tri.amin(dim=0)).all())
        assert bool((c_hi[c] > tri.amax(dim=0)).all())


def test_culled_model_matches_jax_kernel(problem):
    o, d, t_max = (a[:R_JAX] for a in problem["rays"]["camera"])
    ref = jvm.vmem_intersect(problem["jpacked"], jnp.asarray(o),
                             jnp.asarray(d), 1e-4, jnp.asarray(t_max),
                             interpret=True)
    got = tvm.vmem_intersect_reference(problem["packed"], torch.tensor(o),
                                       torch.tensor(d), 1e-4,
                                       torch.tensor(t_max), culled=True)
    prim = np.asarray(ref.prim)
    np.testing.assert_array_equal(got.prim.numpy(), prim)
    hit = prim >= 0
    assert hit.sum() > hit.size // 8
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=1e-5)
    for a, b in ((got.u, ref.u), (got.v, ref.v)):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit],
                                   rtol=1e-4, atol=1e-5)
    assert np.isinf(got.t.numpy()[~hit]).all()


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(problem):
    """Checked before anything is built or launched."""
    packed = problem["packed"]
    o, d, _ = (torch.tensor(a[:64]) for a in problem["rays"]["incoherent"])
    with pytest.raises(ValueError, match=r"\[r, 3\]"):
        tvm.vmem_intersect_cuda(packed, o[:, :2], d, 1e-4, 1.0)
    with pytest.raises(ValueError, match="must hold a triangle"):
        tvm.vmem_intersect_cuda(packed._replace(n_tris=2048), o, d, 1e-4, 1.0)
    with pytest.raises(ValueError, match="tri_planes"):
        tvm.vmem_intersect_cuda(
            packed._replace(tri_planes=packed.tri_planes[:9]), o, d, 1e-4, 1.0)
