"""The mesh megakernel's dense trace as the kernel runs it, on the CPU: the
chunk cull's plain version (``culled_dense_intersect_reference``) against
the JAX package's dense trace kernel in Pallas interpret mode, and the
host-side caches of a frame (the eligibility verdict, the frame's tables)
that spare a frame after a scene's first every host sync."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bifrost3d_tpu.geometry import pallas_intersect as jpi

from bifrost3d_tpu_torch.apps.scenes import create_cornell_box
from bifrost3d_tpu_torch.geometry.creation import make_plane, make_sphere
from bifrost3d_tpu_torch.geometry import pallas_intersect as tpi
from bifrost3d_tpu_torch.integrator import pallas_mesh as tpm
from bifrost3d_tpu_torch.integrator import path_tracer as tpt
import torch_parity  # noqa: F401  (one torch thread per worker)

R = 2 * jpi.BLOCK_R     # two 256-ray blocks


def _soup(name):
    """A sphere over a floor (ordered strips, as Sphere's table) or seeded
    random triangles, under MAX_TRIS."""
    if name == "sphere":
        sphere = make_sphere(radius=0.5, slices=16, stacks=10)
        floor = make_plane(size=6.0)
        floor = floor._replace(positions=floor.positions
                               + np.asarray([0, -0.5, 0], np.float32))
        return np.concatenate([m.positions[m.indices]
                               for m in (floor, sphere)]).astype(np.float32)
    rng = np.random.default_rng(21)
    return (rng.uniform(-1.0, 1.0, size=(300, 1, 3))
            + rng.normal(scale=0.2, size=(300, 3, 3))).astype(np.float32)


def _rays(seed):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(R, 3)).astype(np.float32)
    o = 1.6 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    aim = -o + rng.normal(scale=0.5, size=(R, 3)).astype(np.float32)
    d = aim / np.linalg.norm(aim, axis=-1, keepdims=True)
    t_max = rng.uniform(0.5, 3.0, size=R).astype(np.float32)
    return o, d, t_max


@pytest.fixture(scope="module", params=["sphere", "random"])
def traced(request):
    """(soup, rays, JAX's interpret-mode hits for t_max = inf and for the
    per-ray t_max)."""
    tris = _soup(request.param)
    o, d, t_max = _rays(3)
    comp, n = jpi.pack_triangles(jnp.asarray(tris))
    refs = [jpi.pallas_intersect(comp, n, jnp.asarray(o), jnp.asarray(d),
                                 1e-4, bound, interpret=True)
            for bound in (jnp.inf, jnp.asarray(t_max))]
    return tris, (o, d, t_max), [tuple(np.asarray(f) for f in ref)
                                 for ref in refs]


@pytest.mark.parametrize("bounded", [False, True])
def test_culled_trace_matches_jax_kernel(traced, bounded):
    """The cull skips only chunks that hold no winner: the hits are the JAX
    kernel's full scan's (strict '<' in index order), t, u, v to float32
    rounding."""
    tris, (o, d, t_max), refs = traced
    table = tpm.dense_table(torch.tensor(tris))
    bound = torch.tensor(t_max) if bounded else float("inf")
    stats = {}
    got = tpm.culled_dense_intersect_reference(
        table, len(tris), torch.tensor(o), torch.tensor(d), 1e-4, bound,
        stats=stats)
    ref_t, ref_prim, ref_u, ref_v = refs[int(bounded)]
    np.testing.assert_array_equal(got.prim.numpy(), ref_prim)
    hit = ref_prim >= 0
    assert hit.sum() > R // 10
    # t to 1e-5, the barycentrics (a difference of products) to 1e-4.
    np.testing.assert_allclose(got.t.numpy()[hit], ref_t[hit], rtol=1e-5,
                               atol=1e-6)
    for a, b in ((got.u, ref_u), (got.v, ref_v)):
        np.testing.assert_allclose(a.numpy()[hit], b[hit], rtol=1e-4,
                                   atol=1e-5)
    # Every ray tests every chunk box, and fewer triangles than a full scan.
    n_chunks = -(-len(tris) // tpm.CHUNK)
    assert stats["box_tests"] == R * n_chunks
    assert 0 < stats["tri_tests"] < R * len(tris)


def test_culled_any_hit_matches_jax_occlusion(traced):
    """Any-hit within t_max: occluded exactly where the JAX kernel finds a
    hit, and no more triangles tested than the closest-hit query."""
    tris, (o, d, t_max), refs = traced
    table = tpm.dense_table(torch.tensor(tris))
    args = (table, len(tris), torch.tensor(o), torch.tensor(d), 1e-4,
            torch.tensor(t_max))
    any_stats, closest_stats = {}, {}
    occ = tpm.culled_dense_intersect_reference(*args, any_hit=True,
                                               stats=any_stats)
    tpm.culled_dense_intersect_reference(*args, stats=closest_stats)
    np.testing.assert_array_equal(occ.prim.numpy() >= 0, refs[1][1] >= 0)
    assert any_stats["tri_tests"] <= closest_stats["tri_tests"]


def test_culled_trace_counts_only_live_lanes():
    tris = _soup("random")
    o, d, _ = _rays(4)
    table = tpm.dense_table(torch.tensor(tris))
    live = torch.arange(R) < R // 4
    full, part = {}, {}
    args = (table, len(tris), torch.tensor(o), torch.tensor(d), 1e-4,
            float("inf"))
    tpm.culled_dense_intersect_reference(*args, stats=full)
    tpm.culled_dense_intersect_reference(*args, live=live, stats=part)
    n_chunks = -(-len(tris) // tpm.CHUNK)
    assert part["box_tests"] == (R // 4) * n_chunks
    assert 0 < part["tri_tests"] < full["tri_tests"]


def test_chunk_boxes_hold_their_triangles():
    tris = _soup("sphere")
    table = tpm.dense_table(torch.tensor(tris))
    lo, hi = tpm.chunk_boxes(table, len(tris))
    assert lo.shape == (-(-len(tris) // tpm.CHUNK), 3)
    corners = torch.tensor(tris)
    for c in range(lo.shape[0]):
        part = corners[c * tpm.CHUNK:(c + 1) * tpm.CHUNK].reshape(-1, 3)
        assert bool((part > lo[c]).all() and (part < hi[c]).all())
    # The dense table is the JAX packing's rows, transposed.
    comp, _ = tpi.pack_triangles(corners)
    torch.testing.assert_close(table[:len(tris), 0:9],
                               comp[0:9, :len(tris)].T, rtol=0.0, atol=0.0)


def test_frame_caches_skip_the_host_after_the_first_frame(monkeypatch):
    """The eligibility verdict and the frame's tables are read on the host
    once per (identity, version) of the scene's tensors: a second frame
    asks for neither, an in-place write asks again."""
    scene, cam = create_cornell_box(device="cpu")
    settings = tpt.RenderSettings(max_bounce_count=1)
    assert tpm.mesh_megakernel_eligible(scene, settings)
    first = tpm._frame_tables(scene, settings)

    def refuse(*args):
        raise AssertionError("read on the host again")

    monkeypatch.setattr(tpm, "megakernel_ineligibility_reasons", refuse)
    monkeypatch.setattr(tpm, "_pack_scene", refuse)
    assert tpm.mesh_megakernel_eligible(scene, settings)
    assert tpm._frame_tables(scene, settings) is first
    img, rays = tpm.render_mesh_megakernel(scene, cam, 8, 8, 0, settings)
    assert float(rays) > 0
    with torch.no_grad():
        scene.lights.power.mul_(2.0)
    with pytest.raises(AssertionError, match="read on the host again"):
        tpm.mesh_megakernel_eligible(scene, settings)
