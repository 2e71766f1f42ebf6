"""The chunk cull of the dense trace (B1) and of the cluster scan (B6), on
the CPU: the plain versions of the CUDA kernels' cull against the full
scans they replace (bit for bit) and against the JAX package's kernels in
Pallas interpret mode, their work counts, and the pooled wavefront's live
prefix, which the dense trace now reads.

Inputs come from numpy seeds. Against JAX: prim equal; t within rtol 1e-5;
u, v within rtol 1e-4, atol 1e-5 (a barycentric is a difference of
products that XLA and PyTorch contract differently).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bifrost3d_tpu.geometry import bvh as jbvh
from bifrost3d_tpu.geometry import pallas_clustered as jcl
from bifrost3d_tpu.geometry import pallas_intersect as jpi

from bifrost3d_tpu_torch.apps.scenes import create_cornell_box
from bifrost3d_tpu_torch.geometry import bvh as tbvh
from bifrost3d_tpu_torch.geometry import pallas_clustered as tcl
from bifrost3d_tpu_torch.geometry import pallas_intersect as tpi
from bifrost3d_tpu_torch.integrator import path_tracer as tpt
from torch_parity import bvh_arrays

R = 1024                # four 256-ray blocks
LIVE = 512              # a live prefix of whole blocks, as JAX skips them
CASES = ("inf", "t_max", "live")


def _random_soup(n, seed, scale=0.15):
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-1, 1, size=(n, 1, 3))
    return (centre + rng.normal(scale=scale, size=(n, 3, 3))).astype(np.float32)


def _flat_soup(seed):
    """Eight flat patches, each a grid of 8 x 6 quads (96 triangles) in an
    axis plane or a tilted one: chunk boxes of zero thickness, which only
    their padding keeps open."""
    rng = np.random.default_rng(seed)
    xs, ys = np.linspace(-0.3, 0.3, 9), np.linspace(-0.3, 0.3, 7)
    quads = [((xs[i], ys[j]), (xs[i + 1], ys[j]), (xs[i + 1], ys[j + 1]),
              (xs[i], ys[j + 1])) for i in range(8) for j in range(6)]
    grid = np.asarray([tri for a, b, c, e in quads for tri in ((a, b, c),
                                                              (a, c, e))])
    patches = []
    for k in range(8):
        tri = np.zeros((96, 3, 3), np.float32)
        tri[..., 0:2] = grid + rng.uniform(-0.4, 0.4, size=2)
        tri[..., 2] = 0.2 * k - 0.7
        if k % 2:   # tilted about x
            c, s = np.cos(0.6), np.sin(0.6)
            y, z = tri[..., 1].copy(), tri[..., 2].copy()
            tri[..., 1], tri[..., 2] = c * y - s * z, s * y + c * z
        patches.append(tri)
    return np.concatenate(patches).astype(np.float32)


def _soup(name):
    if name == "cornell":
        return create_cornell_box(device="cpu")[0].tri_verts.numpy()
    if name == "random":
        return _random_soup(1500, 31)
    return _flat_soup(32)


def _rays(name, r=R, seed=33):
    rng = np.random.default_rng(seed)
    if name == "cornell":
        # In the room's free space above both boxes.
        o = rng.uniform((-0.45, 0.12, -0.45), (0.45, 0.45, 0.45), size=(r, 3))
        d = rng.normal(size=(r, 3))
    else:
        o = rng.uniform(-2, 2, size=(r, 3))
        d = rng.uniform(-0.8, 0.8, size=(r, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = rng.uniform(0.3, 3.0, size=r)
    return [a.astype(np.float32) for a in (o, d, t_max)]


def _bounds(case, t_max):
    bound = t_max if case == "t_max" else np.float32(np.inf)
    return bound, (LIVE if case == "live" else None)


@pytest.fixture(scope="module", params=["cornell", "random", "flat"])
def dense(request):
    """(soup name, packed [16, T_pad] table, n, rays, JAX's interpret-mode
    hits per case)."""
    tris = _soup(request.param)
    o, d, t_max = _rays(request.param)
    jcomp, n = jpi.pack_triangles(jnp.asarray(tris))
    refs = {}
    for case in CASES:
        bound, live = _bounds(case, t_max)
        refs[case] = jpi.pallas_intersect(
            jcomp, n, jnp.asarray(o), jnp.asarray(d), 1e-4,
            jnp.asarray(bound), interpret=True,
            live_count=None if live is None else jnp.int32(live))
    comp, _ = tpi.pack_triangles(torch.tensor(tris))
    return request.param, comp, n, (o, d, t_max), refs


def _culled(comp, n, rays, case, **kw):
    o, d, t_max = rays
    bound, live = _bounds(case, t_max)
    return tpi.culled_dense_intersect_reference(
        comp, n, torch.tensor(o), torch.tensor(d), 1e-4, torch.tensor(bound),
        live_count=live, groups=True, **kw)


def _assert_bit_equal(got, ref):
    assert torch.equal(got.prim, ref.prim)
    for a, b in ((got.t, ref.t), (got.u, ref.u), (got.v, ref.v)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _assert_matches_jax(got, ref):
    prim = np.asarray(ref.prim)
    np.testing.assert_array_equal(got.prim.numpy(), prim)
    hit = prim >= 0
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=1e-5)
    for a, b in ((got.u, ref.u), (got.v, ref.v)):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit],
                                   rtol=1e-4, atol=1e-5)
    assert np.isinf(got.t.numpy()[~hit]).all()


@pytest.mark.parametrize("case", CASES)
def test_dense_cull_equals_full_scan(dense, case):
    """The cull (chunk and group boxes) skips only triangles no ray would
    take: prim on every ray and t, u, v bit for bit are the full scan's."""
    _, comp, n, rays, _ = dense
    o, d, t_max = rays
    bound, live = _bounds(case, t_max)
    ref = tpi.dense_intersect_reference(comp, n, torch.tensor(o),
                                        torch.tensor(d), 1e-4,
                                        torch.tensor(bound), live)
    _assert_bit_equal(_culled(comp, n, rays, case), ref)
    assert int((ref.prim >= 0).sum()) > R // 10


@pytest.mark.parametrize("case", CASES)
def test_dense_cull_and_full_scan_match_jax_kernel(dense, case):
    _, comp, n, rays, refs = dense
    o, d, t_max = rays
    bound, live = _bounds(case, t_max)
    _assert_matches_jax(_culled(comp, n, rays, case), refs[case])
    _assert_matches_jax(tpi.pallas_intersect(
        comp, n, torch.tensor(o), torch.tensor(d), 1e-4, torch.tensor(bound),
        live_count=live), refs[case])


def test_dense_cull_partial_live_block(dense):
    """A live count inside a block: the rays past it miss, the others are
    the full scan's."""
    _, comp, n, (o, d, _), _ = dense
    args = (comp, n, torch.tensor(o), torch.tensor(d), 1e-4, float("inf"))
    live = torch.tensor(LIVE + 77)
    got = tpi.culled_dense_intersect_reference(*args, live_count=live,
                                               groups=True)
    _assert_bit_equal(got, tpi.dense_intersect_reference(*args, live))
    assert bool((got.prim[LIVE + 77:] == -1).all())


def test_dense_cull_counts_less_work_than_full_scan(dense):
    _, comp, n, rays, _ = dense
    plain, grouped = {}, {}
    _culled(comp, n, rays, "inf", stats=grouped)
    o, d, _ = rays
    tpi.culled_dense_intersect_reference(comp, n, torch.tensor(o),
                                         torch.tensor(d), 1e-4, float("inf"),
                                         stats=plain)
    n_chunks, n_groups = tpi.box_counts(n)
    assert grouped["group_tests"] == R * n_groups
    assert plain["box_tests"] == R * n_chunks
    # The group boxes spare chunk-box tests and change no triangle test.
    assert grouped["box_tests"] <= plain["box_tests"]
    assert grouped["tri_tests"] == plain["tri_tests"]
    assert 0 < grouped["tri_tests"] < R * n
    assert 0 < grouped["chunks_read"] <= n_chunks


def test_dense_any_hit_occlusion_is_closest_hits(dense):
    _, comp, n, rays, _ = dense
    closest = _culled(comp, n, rays, "t_max")
    stats_any, stats_closest = {}, {}
    occluded = _culled(comp, n, rays, "t_max", any_hit=True, stats=stats_any)
    _culled(comp, n, rays, "t_max", stats=stats_closest)
    assert torch.equal(occluded.prim >= 0, closest.prim >= 0)
    assert stats_any["tri_tests"] <= stats_closest["tri_tests"]


def test_triangle_rows_reads_both_layouts():
    tris = torch.tensor(_soup("random")[:300])
    comp, n = tpi.pack_triangles(tris)
    table = torch.zeros((304, 16))
    table[:n, 0:9] = comp[0:9, :n].T
    assert torch.equal(tpi.triangle_rows(comp, n), tpi.triangle_rows(table, n))
    for a, b in zip(tpi.chunk_boxes(comp, n), tpi.chunk_boxes(table, n)):
        assert torch.equal(a, b)


# -- the cluster scan (B6) ----------------------------------------------------------

N_CLUSTER_TRIS = 2000   # four clusters, the last one partly filled


def _camera_rays(n):
    side = int(np.ceil(np.sqrt(n)))
    xs, ys = np.meshgrid(np.linspace(-0.25, 0.25, side),
                         np.linspace(-0.25, 0.25, side))
    d = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3)[:n]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o = np.broadcast_to(np.asarray([0.3, -0.2, -3.0], np.float32),
                        d.shape).copy()
    return o, d


@pytest.fixture(scope="module")
def clusters():
    tris = _random_soup(N_CLUSTER_TRIS, 34, scale=0.08)
    flat = tris.reshape(-1, 3)
    jb = jbvh.build_bvh(flat, np.arange(flat.shape[0], dtype=np.int32)
                        .reshape(-1, 3))
    packed = tcl.pack_clustered(
        torch.tensor(tris), tbvh.BVH.from_numpy(bvh_arrays(jb), device="cpu"))
    return jcl.pack_clustered(tris, jb), packed


@pytest.mark.parametrize("rays", ["camera", "incoherent"])
def test_cluster_cull_model_equals_scan(clusters, rays):
    """Inside a fetched cluster a ray culls by the cluster's padded box and
    its chunk boxes: hits bit for bit the scan's, against JAX's kernel under
    the gate, and fewer triangle tests than every ray of a fetching block
    against all 512."""
    jpacked, packed = clusters
    if rays == "camera":
        o, d = _camera_rays(R)
    else:       # test_torch_clustered.py's incoherent set
        rng = np.random.default_rng(35)
        o = rng.uniform(-1.5, 1.5, size=(R, 3)).astype(np.float32)
        d = rng.normal(size=(R, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
    full_stats, stats = {}, {}
    args = (packed, torch.tensor(o), torch.tensor(d), 1e-4, float("inf"))
    ref = tcl.clustered_intersect_reference(*args, stats=full_stats)
    got = tcl.clustered_intersect_reference(*args, stats=stats, culled=True)
    _assert_bit_equal(got, ref)
    assert int((ref.prim >= 0).sum()) > R // 8
    jref = jcl.clustered_intersect(jpacked, jnp.asarray(o), jnp.asarray(d),
                                   1e-4, jnp.float32(np.inf), interpret=True)
    _assert_matches_jax(got, jref)
    assert stats["fetches"] == full_stats["fetches"]
    assert stats["clusters_read"] == full_stats["clusters_read"]
    assert stats["cluster_tests"] == tcl.BLOCK_R * stats["fetches"]
    assert 0 < stats["tri_tests"] < (tcl.BLOCK_R * tcl.CLUSTER_T
                                     * stats["fetches"])
    assert stats["box_tests"] <= 16 * stats["cluster_tests"]


# -- the pooled wavefront's live prefix ----------------------------------------------

def test_sorted_dense_pool_passes_its_live_prefix(monkeypatch):
    """With the pool sorted every step the dense trace is handed the live
    count (as JAX's wavefront does); the frame equals the one traced
    without it."""
    scene, cam = create_cornell_box(device="cpu")
    settings = tpt.settings_for_scene(scene, max_bounce_count=2,
                                      sort_rays_every=1)
    trace = tpi.pallas_intersect
    seen = []

    def counted(*args, live_count=None, **kw):
        seen.append(live_count is not None)
        return trace(*args, live_count=live_count, **kw)

    monkeypatch.setattr(tpi, "pallas_intersect", counted)
    img = tpt.render_sample_pooled(scene, cam, 16, 16, 1, settings)
    assert seen and all(seen)

    def unbounded(*args, live_count=None, **kw):
        return trace(*args, **kw)

    monkeypatch.setattr(tpi, "pallas_intersect", unbounded)
    ref = tpt.render_sample_pooled(scene, cam, 16, 16, 1, settings)
    assert torch.equal(img, ref)
    assert float(img.mean()) > 0.01
