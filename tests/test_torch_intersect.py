"""The dense trace (kernel B1) of the port against the JAX package.

On the CPU the port's wrapper takes the kernel's plain PyTorch version;
it is held prim-exact (t/u/v allclose, rtol 1e-5) against JAX
``pallas_intersect`` in Pallas interpret mode — run as
tests/test_pallas_bvh.py runs it — and against the XLA brute force
``intersect_triangles_brute``. The CUDA kernel itself is compared with
the plain version only where a card is present.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bifrost3d_tpu.geometry import pallas_intersect as jpi
from bifrost3d_tpu.geometry import traverse as jtr

from bifrost3d_tpu_torch.geometry import pallas_intersect as tpi
from bifrost3d_tpu_torch.geometry import traverse as ttr
from bifrost3d_tpu_torch.utils import cuda_build
from torch_parity import assert_kernel_matches_plain

R = 2 * jpi.BLOCK_R     # two 256-ray blocks
N_TRIS = 600            # two 512-triangle DMA blocks, the second ragged


def _soup(n, seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1, 1, size=(n, 1, 3))
    return (centers + rng.normal(scale=0.15, size=(n, 3, 3))).astype(np.float32)


def _rays(r, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, size=(r, 3)).astype(np.float32)
    target = rng.uniform(-0.8, 0.8, size=(r, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = rng.uniform(0.5, 3.0, size=r).astype(np.float32)
    return o, d.astype(np.float32), t_max


@pytest.fixture(scope="module")
def problem():
    tris = _soup(N_TRIS, 11)
    o, d, t_max = _rays(R, 12)
    comp, n = jpi.pack_triangles(jnp.asarray(tris))
    refs = {}
    for case, bound, live in (("inf", jnp.inf, None),
                              ("t_max", jnp.asarray(t_max), None),
                              ("live", jnp.inf, jpi.BLOCK_R)):
        live_arg = None if live is None else jnp.int32(live)
        refs[case] = jpi.pallas_intersect(comp, n, jnp.asarray(o),
                                          jnp.asarray(d), 1e-4, bound,
                                          interpret=True, live_count=live_arg)
    refs["brute"] = jtr.intersect_triangles_brute(
        jnp.asarray(tris), jnp.asarray(o), jnp.asarray(d), 1e-4,
        jnp.asarray(t_max))
    return tris, o, d, t_max, np.asarray(comp), refs


def _assert_hits_match(got, ref):
    """prim equal; t within rtol 1e-5; u, v within 1e-5 of their [0, 1]
    range (each is a difference of products, so XLA's FMA contraction
    moves it by an absolute, not a relative, amount)."""
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(ref.prim))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=1e-5,
                               atol=1e-6)
    for field in ("u", "v"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(ref, field)),
                                   rtol=1e-5, atol=1e-5)


def test_pack_triangles_matches_jax(problem):
    tris, _, _, _, comp, _ = problem
    got, n = tpi.pack_triangles(torch.tensor(tris))
    assert n == N_TRIS
    np.testing.assert_array_equal(got.numpy(), comp)


@pytest.mark.parametrize("case", ["inf", "t_max", "live"])
def test_plain_version_matches_pallas_interpret(problem, case):
    tris, o, d, t_max, comp, refs = problem
    bound = torch.tensor(t_max) if case == "t_max" else float("inf")
    live = jpi.BLOCK_R if case == "live" else None
    got = tpi.pallas_intersect(torch.tensor(comp), N_TRIS, torch.tensor(o),
                               torch.tensor(d), 1e-4, bound, live_count=live)
    _assert_hits_match(got, refs[case])
    assert int((got.prim >= 0).sum()) > R // 4       # the rays hit things
    if case == "live":
        assert bool((got.prim[live:] == -1).all())
        assert bool(torch.isinf(got.t[live:]).all())


def test_plain_version_matches_xla_brute_force(problem):
    tris, o, d, t_max, comp, refs = problem
    got = ttr.intersect_scene(None, torch.tensor(tris), torch.tensor(o),
                              torch.tensor(d), 1e-4, torch.tensor(t_max),
                              tri_components=torch.tensor(comp))
    _assert_hits_match(got, refs["brute"])
    brute = ttr.intersect_triangles_brute(torch.tensor(tris), torch.tensor(o),
                                          torch.tensor(d), 1e-4,
                                          torch.tensor(t_max))
    _assert_hits_match(brute, refs["brute"])


def test_any_hit_matches_jax(problem):
    tris, o, d, t_max, comp, _ = problem
    got = ttr.intersect_scene_any(None, torch.tensor(tris), torch.tensor(o),
                                  torch.tensor(d), 1e-4, torch.tensor(t_max),
                                  tri_components=torch.tensor(comp))
    ref = jtr.intersect_scene_any(None, jnp.asarray(tris), jnp.asarray(o),
                                  jnp.asarray(d), 1e-4, jnp.asarray(t_max))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < int(got.sum()) < R


def test_moller_trumbore_matches_jax(problem):
    tris, o, d, _, _, _ = problem
    args = (o[:, None], d[:, None], tris[None, :, 0], tris[None, :, 1],
            tris[None, :, 2])
    got = ttr.moller_trumbore(*(torch.tensor(a) for a in args))
    ref = jtr.moller_trumbore(*(jnp.asarray(a) for a in args))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    hit = got[3].numpy()
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(g.numpy()[hit], np.asarray(r)[hit],
                                   rtol=1e-5, atol=1e-6)


def test_dispatch_by_device():
    tris = torch.tensor(_soup(8, 3))
    o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="meta"):
        ttr.intersect_scene(None, tris, o, o,
                            tri_components=tpi.pack_triangles(tris)[0])
    with pytest.raises(ValueError, match="meta"):
        tpi.pallas_intersect(tpi.pack_triangles(tris)[0], 8, o, o, 1e-4, 1.0)


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build, "CUDA_HOME_NVCC", "/nonexistent/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build("dense_intersect.cu")


def test_library_path_is_keyed_by_source_hash():
    path = cuda_build.library_path("dense_intersect.cu")
    assert path.startswith(cuda_build.BUILD_DIR)
    assert path == cuda_build.library_path("dense_intersect.cu")
    assert "libdense_intersect_" in path and path.endswith(".so")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["inf", "t_max", "live"])
def test_cuda_kernel_matches_plain_version(problem, case):
    """The kernel itself, where a card is present (more CUDA cases, which
    need no JAX, are in test_torch_cuda.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    tris, o, d, t_max, comp, _ = problem
    dev = torch.device("cuda")
    bound = torch.tensor(t_max, device=dev) if case == "t_max" else float("inf")
    assert_kernel_matches_plain(
        torch.tensor(comp, device=dev), N_TRIS, torch.tensor(o, device=dev),
        torch.tensor(d, device=dev), bound,
        jpi.BLOCK_R // 3 if case == "live" else None)
