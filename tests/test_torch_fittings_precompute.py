"""``shading/fittings.precompute_fittings`` of the port against the JAX
package's, on the CPU, table by table, at 256 samples a cell; both write
under ``tmp_path`` (never into the JAX package's ``data/``).

Gates (my CPU runs):

- ``ggx``, ``ggx_with_fresnel``, ``burley`` (the BRDF rho tables) and
  ``bounded_vndf_alpha`` (40 bisection steps): within 1e-6 of JAX's on
  every cell (measured: 2.4e-7, two float32 ulps of 1.0);
- ``dielectric_light`` / ``dielectric_dense``: each cell is the mean of
  256 sample weights of the combined GGX lobe, and on near-grazing and
  near-smooth lanes that weight's float32 error against float64 reaches
  1% in JAX itself. The integrand is held lane by lane on one IOR slice
  by ``assert_f64_anchored`` (the port's float32 error within 2 × JAX's
  + 4 ulps). Those lanes' errors do not average out over more samples, so
  the tables are held cell by cell within 1e-2 and on average within
  1e-4 (measured: 2.5e-3 and 2.4e-5 here against JAX at 256 samples;
  3.4e-3 and 2.1e-5 at 4,096 against the shipped ``fittings.npz``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifrost3d_tpu.bsdf import ggx as jax_ggx
from bifrost3d_tpu.sampling import pmj02_bn_samples as jax_pmj
from bifrost3d_tpu.sampling.hashes import van_der_corput as jax_vdc
from bifrost3d_tpu.shading import fittings as jax_fittings

from bifrost3d_tpu_torch.bsdf import ggx
from bifrost3d_tpu_torch.sampling.pmj import pmj02_bn_samples
from bifrost3d_tpu_torch.shading import fittings
from torch_parity import assert_f64_anchored

SAMPLES = 256
DIELECTRIC_MAX, DIELECTRIC_MEAN = 1e-2, 1e-4


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    out = tmp_path_factory.mktemp("fittings")
    ref = jax_fittings.precompute_fittings(
        SAMPLES, save_path=str(out / "jax.npz"))
    got = fittings.precompute_fittings(SAMPLES, save_path=str(out / "port.npz"),
                                       device="cpu")
    return ref, got, out


def test_writes_where_asked_and_loads(tables):
    ref, got, out = tables
    with np.load(out / "port.npz") as data:
        assert sorted(data.files) == sorted(fittings.Fittings._fields)
        for name in fittings.Fittings._fields:
            np.testing.assert_array_equal(data[name],
                                          getattr(got, name).numpy())
    assert all(getattr(got, k).device.type == "cpu"
               for k in fittings.Fittings._fields)


@pytest.mark.parametrize("name", ["ggx", "ggx_with_fresnel", "burley",
                                  "bounded_vndf_alpha"])
def test_brdf_and_vndf_tables_match_jax(tables, name):
    ref, got, _ = tables
    want = np.asarray(getattr(ref, name))
    assert getattr(got, name).shape == want.shape
    np.testing.assert_allclose(getattr(got, name).numpy(), want, rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["dielectric_light", "dielectric_dense"])
def test_dielectric_tables_match_jax(tables, name):
    ref, got, _ = tables
    want = np.asarray(getattr(ref, name))
    diff = np.abs(getattr(got, name).numpy() - want)
    assert diff.shape == (16, 16, 16, 2)
    assert diff.max() <= DIELECTRIC_MAX, diff.max()
    assert diff.mean() <= DIELECTRIC_MEAN, diff.mean()


def test_shared_samples_match_jax():
    """Both packages integrate the same PMJ-BN points and the same
    van der Corput third dimension."""
    np.testing.assert_array_equal(pmj02_bn_samples(SAMPLES),
                                  np.asarray(jax_pmj(SAMPLES)))
    from bifrost3d_tpu_torch.sampling.hashes import van_der_corput
    np.testing.assert_array_equal(
        van_der_corput(torch.arange(SAMPLES), 0x9E3779B9).numpy(),
        np.asarray(jax_vdc(jnp.arange(SAMPLES, dtype=jnp.uint32),
                           jnp.uint32(0x9E3779B9))))


def _dielectric_weights(mod, where, maximum, abs_):
    """One IOR slice's sample weights (f·|cos|/pdf) and reflection flags,
    written once for both packages."""
    def run(roughness, spec, ior, wo, u):
        s = mod.sample(mod.alpha_from_roughness(roughness), spec, ior, wo, u)
        w = where(s.pdf > 1e-9, s.reflectance[..., 0]
                  * abs_(s.direction[..., 2]) / maximum(s.pdf, 1e-12), 0.0)
        return w, s.direction[..., 2] * wo[..., 2] > 0
    return run


def test_dielectric_integrand_is_f64_anchored():
    n, s = 16, 64
    u2 = np.asarray(jax_pmj(s))
    u3 = np.concatenate([u2, np.asarray(jax_vdc(
        jnp.arange(s, dtype=jnp.uint32), jnp.uint32(0x9E3779B9)))[:, None]],
        axis=-1).astype(np.float32)
    wo_grid, _ = jax_fittings._grid_wo(n)
    shape = (n, n, s)
    wo = np.ascontiguousarray(np.broadcast_to(wo_grid[None, :, None, :],
                                              shape + (3,)))
    u = np.ascontiguousarray(np.broadcast_to(u3[None, None], shape + (3,)))
    roughness = (np.arange(n, dtype=np.float32) / (n - 1))[:, None, None]
    ior = np.float32(jax_fittings.MIN_DENSE_IOR + 3 * (
        jax_fittings.MAX_DENSE_IOR - jax_fittings.MIN_DENSE_IOR) / (n - 1))
    spec = np.float32(((1.0 - float(ior)) / (1.0 + float(ior))) ** 2)
    assert_f64_anchored(
        _dielectric_weights(ggx, torch.where, torch.clamp_min, torch.abs),
        _dielectric_weights(jax_ggx, jnp.where, jnp.maximum, jnp.abs),
        roughness, np.asarray(spec), np.asarray(ior), wo, u)
