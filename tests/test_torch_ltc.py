"""``math/ltc`` and ``shading/ltc_fit`` of the port against the JAX
package's, on the CPU.

- The LTC math (M, M⁻¹, det, pdf, evaluate, sample, the Oren–Nayar and
  Lambert fits) and the shipped table's bilinear lookup
  (``ggx_reflection_ltc_coefficients``): float64-anchored
  (``torch_parity.assert_f64_anchored``) on seeded inputs.
- The batched Nelder–Mead fit of one roughness row (4 cells, 20
  iterations) in float64: every branch the same as JAX's, the parameters
  and the objective reached within 1e-9 relative (measured 1e-16).
- ``precompute_ggx_ltc`` on a 4 × 4 grid, 20 iterations a row, in float32:
  Nelder–Mead branches on float32 comparisons of the objective, and where
  one comparison falls the other way the two simplices take different
  steps from there (cells of the 4 × 4 table differ by up to 347 in m20
  at roughness 0). The gate is the fit's own objective: each cell's
  objective, evaluated in float64 at the port's parameters, is at most
  1.5 × the one at JAX's (measured 0.43–1.21 ×).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifrost3d_tpu.math import ltc as jax_ltc
from bifrost3d_tpu.shading import ltc_fit as jax_fit

from bifrost3d_tpu_torch.math import ltc
from bifrost3d_tpu_torch.shading import ltc_fit
from torch_parity import assert_f64_anchored

GRID, ITERATIONS = 4, 20


def _params(rng, n):
    """Seeded well-conditioned LTC fields (m00, m11, m22, m02, m20) [n]."""
    return (rng.uniform(0.3, 1.5, (5, n)) * np.array(
        [1, 1, 1, 0.6, 0.6])[:, None]).astype(np.float32)


def _unit_vectors(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _apply(mod, fn):
    def run(p, *rest):
        return fn(mod, mod.IsotropicLTC(*p), *rest)
    return run


@pytest.mark.parametrize("what", ["m_matrix", "inverse_m_matrix",
                                  "inverse_m_determinant"])
def test_matrices_match_jax(what):
    p = _params(np.random.default_rng(1), 512)
    assert_f64_anchored(_apply(ltc, lambda m, l: getattr(m, what)(l)),
                        _apply(jax_ltc, lambda m, l: getattr(m, what)(l)), p)


@pytest.mark.parametrize("what", ["pdf", "evaluate"])
def test_pdf_matches_jax(what):
    rng = np.random.default_rng(2)
    p, w = _params(rng, 4096), _unit_vectors(rng, 4096)
    assert_f64_anchored(_apply(ltc, lambda m, l, w: getattr(m, what)(l, w)),
                        _apply(jax_ltc, lambda m, l, w: getattr(m, what)(l, w)),
                        p, w)


def test_sample_matches_jax():
    rng = np.random.default_rng(3)
    p = _params(rng, 4096)
    u = rng.uniform(0.0, 1.0, (4096, 2)).astype(np.float32)
    assert_f64_anchored(_apply(ltc, lambda m, l, u: m.sample(l, u)),
                        _apply(jax_ltc, lambda m, l, u: m.sample(l, u)), p, u)


def test_oren_nayar_fit_matches_jax():
    rng = np.random.default_rng(4)
    mu = rng.uniform(0.0, 1.0, 2048).astype(np.float32)
    r = rng.uniform(0.0, 1.0, 2048).astype(np.float32)
    assert_f64_anchored(ltc.oren_nayar_ltc_coefficients,
                        jax_ltc.oren_nayar_ltc_coefficients, mu, r)


def test_identity_and_lambert():
    ident = ltc.lambert_ltc_coefficients()
    assert [float(f) for f in ident] == [1.0, 1.0, 1.0, 0.0, 0.0]
    w = torch.tensor([[0, 0, 1.0], [0.6, 0, 0.8], [0.8, 0, -0.6]])
    torch.testing.assert_close(ltc.pdf(ident, w),
                               torch.clamp_min(w[:, 2], 0.0) / np.pi)
    torch.testing.assert_close(ltc.m_matrix(ident), torch.eye(3))


def test_table_lookup_matches_jax():
    rng = np.random.default_rng(5)
    cos_t = rng.uniform(-0.1, 1.1, 2048).astype(np.float32)
    rough = rng.uniform(-0.1, 1.1, 2048).astype(np.float32)
    table = ltc_fit.get_ggx_ltc_table(torch.device("cpu"))
    assert tuple(table.shape) == (64, 64, 4)
    np.testing.assert_array_equal(table.numpy(),
                                  np.asarray(jax_fit.get_ggx_ltc_table()))
    assert_f64_anchored(ltc_fit.ggx_reflection_ltc_coefficients,
                        jax_fit.ggx_reflection_ltc_coefficients, cos_t, rough)


def test_row_fit_is_jax_in_float64():
    from torch_parity import _run_jax, _run_port
    j = 1
    alpha = ltc_fit._row_alpha(j, GRID)
    cos = np.maximum(np.arange(GRID) / (GRID - 1), ltc_fit._MIN_FIT_COS)
    u2 = np.asarray(jax_fit._stratified_u2(16))
    x0 = np.random.default_rng(6).uniform(-0.2, 0.2, (GRID, 4))

    def jax_row(cos, x0, u2):
        objective = jax_fit._make_row_objective(cos, jnp.float32(alpha), u2)
        return jax_fit._batched_nelder_mead(objective, x0, ITERATIONS)

    def port_row(cos, x0, u2):
        return ltc_fit.fit_row(cos, alpha, x0, u2, ITERATIONS)

    want = _run_jax(jax_row, (cos, x0, u2), np.float64)
    got = _run_port(port_row, (cos, x0, u2), np.float64)
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-15)


def _objective64(table, j):
    """The fit's objective of row ``j`` of a GRID × GRID table, in
    float64, at the table's parameters → [GRID]."""
    cos = torch.clamp_min(torch.arange(GRID, dtype=torch.float64)
                          / (GRID - 1), ltc_fit._MIN_FIT_COS)
    objective = ltc_fit._make_row_objective(
        cos, ltc_fit._row_alpha(j, GRID),
        ltc_fit._stratified_u2(16, dtype=torch.float64))
    t = table[j].astype(np.float64)
    p = np.concatenate([np.log(t[:, :2]), t[:, 2:]], axis=-1)
    return objective(torch.tensor(p)[:, None, :])[:, 0].numpy()


def test_precompute_reaches_jax_objective(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_fit, "_NM_ITERATIONS", ITERATIONS)
    monkeypatch.setattr(ltc_fit, "_NM_ITERATIONS", ITERATIONS)
    want = jax_fit.precompute_ggx_ltc(save_path=None, angle_samples=GRID,
                                      roughness_samples=GRID)
    path = tmp_path / "ggx_ltc.npz"
    got = ltc_fit.precompute_ggx_ltc(str(path), GRID, GRID, device="cpu")
    with np.load(path) as data:
        np.testing.assert_array_equal(data["ggx_ltc"], got)
    assert got.shape == want.shape == (GRID, GRID, 4)
    assert np.isfinite(got).all() and (got[..., :2] > 0).all()
    for j in range(GRID):
        ratio = _objective64(got, j) / _objective64(want, j)
        assert (ratio <= 1.5).all(), (j, ratio)
