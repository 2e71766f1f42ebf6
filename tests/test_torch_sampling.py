"""The port's hashes, Sobol chain and distributions against the JAX package.

Hashes and Sobol are bit-exact (including the reference C++ goldens of
tests/test_sobol_parity.py). Distributions are float32 allclose at rtol
1e-5, atol 1e-6 (same formulas, different libm and op order), with the
ill-conditioned-lane allowance of ``torch_parity.assert_close_f32``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bifrost3d_tpu.sampling import distributions as jd
from bifrost3d_tpu.sampling import hashes as jh
from bifrost3d_tpu.sampling import sobol as js

from bifrost3d_tpu_torch.sampling import distributions as td
from bifrost3d_tpu_torch.sampling import hashes as th
from bifrost3d_tpu_torch.sampling import sobol as ts
from test_sobol_parity import GOLDEN
from torch_parity import assert_close_f32, assert_f64_anchored

N = 4096
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def words():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2**32, size=N, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, size=N, dtype=np.uint64).astype(np.uint32)
    a[:4] = (0, 1, 0xFFFFFFFF, 0x80000000)
    return a, b


def _t(x):
    return torch.tensor(np.asarray(x).astype(np.int64))


def _u32(x):
    return np.asarray(x).astype(np.uint32)


def test_reverse_bits_bit_exact(words):
    a, _ = words
    np.testing.assert_array_equal(_u32(th.reverse_bits(_t(a)).numpy()),
                                  np.asarray(jh.reverse_bits(jnp.asarray(a))))


def test_cessen_owen_hash_bit_exact(words):
    a, b = words
    np.testing.assert_array_equal(
        _u32(th.cessen_owen_hash(_t(a), _t(b)).numpy()),
        np.asarray(jh.cessen_owen_hash(jnp.asarray(a), jnp.asarray(b))))


def test_pcg2d_bit_exact(words):
    a, b = words
    tx, ty = th.pcg2d(_t(a), _t(b))
    jx, jy = jh.pcg2d(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(_u32(tx.numpy()), np.asarray(jx))
    np.testing.assert_array_equal(_u32(ty.numpy()), np.asarray(jy))


def test_uint_to_unit_float_exact(words):
    a, _ = words
    np.testing.assert_array_equal(
        th.uint_to_unit_float(_t(a)).numpy(),
        np.asarray(jh.uint_to_unit_float(jnp.asarray(a))))


def test_direction_numbers_match_jax():
    np.testing.assert_array_equal(ts.sobol_direction_numbers(),
                                  js._DIRECTIONS)


def test_sobol_bit_exact_vs_jax(words):
    a, b = words
    index = a % 100_000
    got = ts.sobol_sample_4d_uint(_t(index), _t(b)).numpy()
    ref = np.asarray(js.sobol_sample_4d_uint(jnp.asarray(index),
                                             jnp.asarray(b)))
    np.testing.assert_array_equal(_u32(got), ref)


def test_sobol_chain_bit_exact_vs_reference_cpp():
    keys = list(GOLDEN.keys())
    acc = _t([k[0] for k in keys])
    ph = _t([k[1] for k in keys])
    dim = _t([k[2] for k in keys])
    seed, _ = th.pcg2d(ph, dim)
    got = ts.sobol_sample_4d_uint(acc, seed).numpy()
    np.testing.assert_array_equal(
        _u32(got), np.asarray([GOLDEN[k] for k in keys], np.uint32))


@pytest.mark.parametrize("accumulation", [0, 1, 7, 1000])
def test_path_rng_4d_bit_exact(words, accumulation):
    a, _ = words
    dims = (np.arange(N) % 40).astype(np.uint32)
    got = ts.path_rng_4d(accumulation, _t(a), _t(dims)).numpy()
    ref = np.asarray(js.path_rng_4d(jnp.uint32(accumulation), jnp.asarray(a),
                                    jnp.asarray(dims)))
    np.testing.assert_array_equal(got, ref)


# -- distributions --------------------------------------------------------------

@pytest.fixture(scope="module")
def samples():
    rng = np.random.default_rng(2)
    u2 = rng.uniform(0, 1, size=(N, 2)).astype(np.float32)
    wo = rng.normal(size=(N, 3)).astype(np.float32)
    wo[:, 2] = np.abs(wo[:, 2]) + 0.05
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    alpha = rng.uniform(0.01, 1.0, size=N).astype(np.float32)
    cos_max = rng.uniform(0.0, 0.999, size=N).astype(np.float32)
    return u2, wo, alpha, cos_max


def _close(got, ref):
    if isinstance(got, tuple):
        for g, r in zip(got, ref):
            _close(g, r)
        return
    assert_close_f32(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_disk_cone_hemisphere_samplers(samples):
    u2, _, _, cos_max = samples
    tu, ju = torch.tensor(u2), jnp.asarray(u2)
    _close(td.concentric_disk_sample(tu), jd.concentric_disk_sample(ju))
    _close(td.cone_sample(torch.tensor(cos_max), tu),
           jd.cone_sample(jnp.asarray(cos_max), ju))
    _close(td.uniform_hemisphere_sample(tu), jd.uniform_hemisphere_sample(ju))
    _close(td.cosine_hemisphere_sample(tu), jd.cosine_hemisphere_sample(ju))


def test_ggx_distributions(samples):
    """Gate ``torch_parity.assert_f64_anchored``: float64 identity with
    JAX on every lane, float32 error within 2 × JAX's + 4 ulps (lanes near
    a GGX lobe's peak cancel in ``1 - cos²θ``)."""
    u2, wo, alpha, _ = samples
    assert_f64_anchored(lambda a, w: td.ggx_ndf(a, w[:, 2]),
                        lambda a, w: jd.ggx_ndf(a, w[:, 2]), alpha, wo)
    assert_f64_anchored(td.ggx_lambda, jd._ggx_lambda, alpha, wo)
    assert_f64_anchored(td.ggx_bounded_vndf_sample,
                        jd.ggx_bounded_vndf_sample, alpha, wo, u2)
    wi, _ = td.ggx_bounded_vndf_sample(torch.tensor(alpha), torch.tensor(wo),
                                       torch.tensor(u2))
    assert_f64_anchored(td.ggx_bounded_vndf_pdf, jd.ggx_bounded_vndf_pdf,
                        alpha, wo, wi.numpy())


def test_oren_nayar_cltc(samples):
    """Gate ``assert_f64_anchored``, as test_ggx_distributions."""
    u2, wo, alpha, _ = samples
    assert_f64_anchored(td.oren_nayar_cltc_sample, jd.oren_nayar_cltc_sample,
                        alpha, wo, u2)
    wi, _ = td.oren_nayar_cltc_sample(torch.tensor(alpha), torch.tensor(wo),
                                      torch.tensor(u2))
    assert_f64_anchored(td.oren_nayar_cltc_pdf, jd.oren_nayar_cltc_pdf,
                        alpha, wo, wi.numpy())
