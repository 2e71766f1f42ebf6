"""The port's environment light and its tables against the JAX package.

Inputs are made from a seed with numpy and fed to both packages. Tables
built by both from the same map are compared as tables; the functions that
read them (evaluate, pdf, sample, the presampled pool) are compared on the
JAX package's own tables carried across, so that a difference is the
function's and not the table's rounding.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bifrost3d_tpu.lights import environment as jenv
from bifrost3d_tpu.math import color as jcolor
from bifrost3d_tpu.math.distribution1d import Distribution1D as JDistribution1D
from bifrost3d_tpu.math.distribution2d import Distribution2D as JDistribution2D
from bifrost3d_tpu.math.distribution2d import (
    _searchsorted_rows as j_searchsorted_rows)
from bifrost3d_tpu.sampling import pmj as jpmj

from bifrost3d_tpu_torch.lights import environment as tenv
from bifrost3d_tpu_torch.math import color as tcolor
from bifrost3d_tpu_torch.math.distribution1d import Distribution1D
from bifrost3d_tpu_torch.math.distribution2d import (
    Distribution2D,
    _searchsorted_rows,
)
from bifrost3d_tpu_torch.sampling import pmj as tpmj
from torch_parity import _to_numpy, assert_close_f32

RTOL = 1e-5


def _map(seed, h, w, black_rows=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 2.0, size=(h, w, 3)).astype(np.float32)
    img[h // 3, w // 4] = 50.0                    # one bright texel
    img[:black_rows] = 0.0
    return img


def _directions(seed, n=4096):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # The poles, the u seam (atan2 = ±π) and directions just off it.
    special = np.asarray([[0, 1, 0], [0, -1, 0], [-1, 0, 0], [-1, 0, 1e-4],
                          [-1, 0, -1e-4], [1, 0, 0], [0, 0, 1], [0, 0, -1]],
                         np.float32)
    special /= np.linalg.norm(special, axis=-1, keepdims=True)
    return np.concatenate([special, d])


def _carried(jlight):
    return tenv.EnvironmentLight.from_numpy(_to_numpy(jlight), device="cpu")


# -- the PMJ pool's randoms ---------------------------------------------------

@pytest.mark.parametrize("count, candidates", [
    (1, 8), (16, 8), (64, 4), (100, 8), (1024, 8)])
def test_pmj02_bn_samples_exact(count, candidates):
    ref = jpmj.pmj02_bn_samples(count, candidates)
    got = tpmj.pmj02_bn_samples(count, candidates)
    assert got.dtype == np.float32 and got.shape == (count, 2)
    np.testing.assert_array_equal(got, ref)
    assert tpmj.pmj02_bn_samples(count, candidates) is got   # kept


def test_pmj_cache_lives_under_build():
    assert tpmj._DISK_CACHE_DIR.endswith("build/pmj")


def test_pmj_construction_is_exact_and_progressive():
    """Straight from the construction, no file in between; a shorter
    sequence is a prefix of a longer one, which the file check relies on."""
    fresh = tpmj._construct(256, 8, 19349669)
    np.testing.assert_array_equal(fresh, jpmj.pmj02_bn_samples(256, 8))
    for k in (1, 2, 3, 64, 100):
        np.testing.assert_array_equal(tpmj._construct(k, 8, 19349669),
                                      fresh[:k])


@pytest.mark.parametrize("fault", ["stale", "truncated", "wrong_shape"])
def test_pmj_disk_cache_rejects_a_wrong_file(tmp_path, monkeypatch, fault):
    monkeypatch.setattr(tpmj, "_DISK_CACHE_DIR", str(tmp_path))
    count, seed = 128, 7
    good = tpmj._construct(count, 8, seed)
    path = tmp_path / f"pmj02bn_{count}_8_{seed}.npy"
    if fault == "stale":        # right shape and type, another sequence
        np.save(path, tpmj._construct(count, 8, seed + 1))
    elif fault == "wrong_shape":
        np.save(path, good[:100])
    else:
        np.save(path, good)
        path.write_bytes(path.read_bytes()[:300])
    with pytest.warns(UserWarning, match="constructed anew"):
        got = tpmj._generate(count, 8, seed)
    np.testing.assert_array_equal(got, good)
    np.testing.assert_array_equal(np.load(path), good)   # written again
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        np.testing.assert_array_equal(tpmj._generate(count, 8, seed), good)


def test_pmj_warns_when_it_cannot_keep_the_file(tmp_path, monkeypatch):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    monkeypatch.setattr(tpmj, "_DISK_CACHE_DIR", str(blocker / "pmj"))
    with pytest.warns(UserWarning, match="could not be kept"):
        got = tpmj._generate(16, 8, 3)
    np.testing.assert_array_equal(got, tpmj._construct(16, 8, 3))


# -- distributions --------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "zero_row", "all_zero"])
def test_distribution2d_build_matches_jax(case):
    rng = np.random.default_rng(3)
    f = rng.uniform(0.0, 4.0, size=(16, 32)).astype(np.float32)
    if case == "zero_row":
        f[5] = 0.0
    elif case == "all_zero":
        f[:] = 0.0
    ref = JDistribution2D.build(jnp.asarray(f))
    got = Distribution2D.build(torch.tensor(f))
    assert (got.width, got.height) == (ref.width, ref.height) == (32, 16)
    for name in ("marginal_cdf", "conditional_cdf", "integral"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=RTOL, atol=1e-7, err_msg=name)


def _carried_distribution(seed=4):
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.0, 4.0, size=(24, 40)).astype(np.float32)
    f[7] = 0.0
    ref = JDistribution2D.build(jnp.asarray(f))
    got = Distribution2D(*(torch.tensor(np.asarray(a)) for a in ref))
    return ref, got


def test_distribution2d_sample_and_pdf_match_jax():
    ref, got = _carried_distribution()
    rng = np.random.default_rng(5)
    u2 = rng.uniform(size=(4096, 2)).astype(np.float32)
    u2[:4] = [[0, 0], [0.999999, 0.999999], [0.5, 0], [0, 0.5]]
    # Samples that sit exactly on CDF entries: the search's side matters.
    u2[4:28, 1] = np.asarray(ref.marginal_cdf)[:-1]
    u2[28:68, 0] = np.asarray(ref.conditional_cdf)[3, :-1]
    u2[28:68, 1] = (3 + 0.5) / 24
    ruv, rpdf = ref.sample_continuous(jnp.asarray(u2))
    guv, gpdf = got.sample_continuous(torch.tensor(u2))
    np.testing.assert_allclose(guv.numpy(), np.asarray(ruv), rtol=RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(gpdf.numpy(), np.asarray(rpdf), rtol=RTOL)
    uv = rng.uniform(size=(1000, 2)).astype(np.float32)
    np.testing.assert_allclose(
        got.pdf_continuous(torch.tensor(uv)).numpy(),
        np.asarray(ref.pdf_continuous(jnp.asarray(uv))), rtol=RTOL)
    np.testing.assert_allclose(
        got.evaluate(torch.tensor(uv)).numpy(),
        np.asarray(ref.evaluate(jnp.asarray(uv))), rtol=RTOL)


def test_searchsorted_rows_matches_jax():
    ref, got = _carried_distribution()
    rng = np.random.default_rng(6)
    rows = rng.integers(0, 24, size=512)
    u = rng.uniform(size=512).astype(np.float32)
    u[:40] = np.asarray(ref.conditional_cdf)[rows[:40], :40].diagonal()
    r = j_searchsorted_rows(ref.conditional_cdf[rows], jnp.asarray(u))
    g = _searchsorted_rows(got.conditional_cdf[torch.tensor(rows)],
                           torch.tensor(u))
    np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_distribution1d_matches_jax():
    rng = np.random.default_rng(7)
    f = rng.uniform(0.0, 3.0, size=50).astype(np.float32)
    f[10:13] = 0.0
    ref = JDistribution1D.build(jnp.asarray(f))
    built = Distribution1D.build(torch.tensor(f))
    np.testing.assert_allclose(built.cdf.numpy(), np.asarray(ref.cdf),
                               rtol=RTOL, atol=1e-7)
    got = Distribution1D(torch.tensor(np.asarray(ref.cdf)),
                         torch.tensor(np.asarray(ref.integral)))
    assert got.element_count == ref.element_count == 50
    u = rng.uniform(size=2000).astype(np.float32)
    u[:50] = np.asarray(ref.cdf)[:-1]
    ri, rp = ref.sample_discrete(jnp.asarray(u))
    gi, gp = got.sample_discrete(torch.tensor(u))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gp.numpy(), np.asarray(rp), rtol=RTOL)
    rx, rpdf = ref.sample_continuous(jnp.asarray(u))
    gx, gpdf = got.sample_continuous(torch.tensor(u))
    np.testing.assert_allclose(gx.numpy(), np.asarray(rx), rtol=RTOL,
                               atol=1e-7)
    np.testing.assert_allclose(gpdf.numpy(), np.asarray(rpdf), rtol=RTOL)
    x = rng.uniform(size=500).astype(np.float32)
    np.testing.assert_allclose(got.evaluate(torch.tensor(x)).numpy(),
                               np.asarray(ref.evaluate(jnp.asarray(x))),
                               rtol=RTOL)
    np.testing.assert_allclose(got.pdf_continuous(torch.tensor(x)).numpy(),
                               np.asarray(ref.pdf_continuous(jnp.asarray(x))),
                               rtol=RTOL)
    zero = Distribution1D.build(torch.zeros(8))
    np.testing.assert_allclose(zero.cdf.numpy(), np.arange(9) / 8)


# -- the light's tables -----------------------------------------------------------

@pytest.mark.parametrize("shape, bilinear, black_rows", [
    ((16, 32), True, 0),      # resampled to 128 rows, blurred
    ((128, 64), True, 3),     # at its own height, blurred
    ((128, 64), False, 3),    # neither: black texels keep a zero pdf
    ((160, 24), True, 0),
])
def test_build_environment_light_tables_match_jax(shape, bilinear,
                                                  black_rows):
    img = _map(11, *shape, black_rows=black_rows)
    tint = (0.9, 0.8, 0.7)
    ref = jenv.build_environment_light(img, tint, bilinear)
    got = tenv.build_environment_light(img, tint, bilinear, device="cpu")
    assert got.pdf_size == tuple(ref.pdf_size)
    assert got.pdf_size == (max(shape[0], tenv.MINIMUM_PDF_HEIGHT), shape[1])
    np.testing.assert_array_equal(got.image.numpy(), np.asarray(ref.image))
    np.testing.assert_array_equal(got.tint.numpy(), np.asarray(ref.tint))
    for name in ("marginal_cdf", "conditional_cdf", "integral"):
        np.testing.assert_allclose(
            getattr(got.distribution, name).numpy(),
            np.asarray(getattr(ref.distribution, name)), rtol=RTOL,
            atol=1e-7, err_msg=name)
    # The per-pixel pdf is a product of CDF differences: entries that agree
    # to a float32 ulp of 1 leave differences that agree to ~1e-7 absolute,
    # times the grid's scale w·h/(2π²).
    ph, pw = got.pdf_size
    atol = 4e-7 * pw * ph / (2 * np.pi ** 2) / max(pw, ph) * 4
    np.testing.assert_allclose(got.per_pixel_pdf.numpy(),
                               np.asarray(ref.per_pixel_pdf), rtol=RTOL,
                               atol=atol)
    if not bilinear and black_rows:
        assert float(got.per_pixel_pdf[:black_rows].abs().max()) == 0.0


def test_latlong_mappings_match_jax():
    d = _directions(12)
    ruv = jenv.direction_to_latlong_uv(jnp.asarray(d))
    guv = tenv.direction_to_latlong_uv(torch.tensor(d))
    np.testing.assert_allclose(guv.numpy(), np.asarray(ruv), rtol=RTOL,
                               atol=1e-6)
    rng = np.random.default_rng(13)
    uv = rng.uniform(size=(2000, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tenv.latlong_uv_to_direction(torch.tensor(uv)).numpy(),
        np.asarray(jenv.latlong_uv_to_direction(jnp.asarray(uv))),
        rtol=RTOL, atol=1e-6)
    # Round trip, away from the poles.
    back = tenv.direction_to_latlong_uv(
        tenv.latlong_uv_to_direction(torch.tensor(uv)))
    inner = (uv[:, 1] > 0.01) & (uv[:, 1] < 0.99)
    np.testing.assert_allclose(back.numpy()[inner], uv[inner], atol=2e-5)


@pytest.fixture(scope="module")
def lights():
    """(JAX light, the port's light carried across) for a map that is
    resampled and one that is not."""
    out = {}
    for name, shape in (("small", (16, 32)), ("tall", (128, 48))):
        jlight = jenv.build_environment_light(_map(21, *shape),
                                              (1.0, 0.9, 0.8))
        out[name] = (jlight, _carried(jlight))
    return out


@pytest.mark.parametrize("name", ["small", "tall"])
def test_environment_evaluate_matches_jax(lights, name):
    jlight, light = lights[name]
    d = _directions(14)
    ref = np.asarray(jenv.environment_evaluate(jlight, jnp.asarray(d)))
    got = tenv.environment_evaluate(light, torch.tensor(d)).numpy()
    # A ulp of atan2 moves the bilinear weights by ~1e-7 · w: the bright
    # texel (50) then moves the result by ~1e-4 absolute.
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=2e-4)


@pytest.mark.parametrize("name", ["small", "tall"])
def test_environment_pdf_matches_jax(lights, name):
    jlight, light = lights[name]
    d = _directions(15)
    ref = np.asarray(jenv.environment_pdf(jlight, jnp.asarray(d)))
    got = tenv.environment_pdf(light, torch.tensor(d)).numpy()
    # The pdf is a cell's constant: a direction within a ulp of a cell
    # border may read the neighbour. At most 0.1% of directions may.
    close = np.isclose(got, ref, rtol=RTOL, atol=0.0)
    assert close.mean() >= 0.999, (1 - close.mean())
    assert got[0] == ref[0] == 0.0 and got[1] == ref[1] == 0.0   # the poles


@pytest.mark.parametrize("name", ["small", "tall"])
def test_environment_sample_matches_jax(lights, name):
    jlight, light = lights[name]
    rng = np.random.default_rng(16)
    u2 = rng.uniform(size=(4096, 2)).astype(np.float32)
    ref = jenv.environment_sample(jlight, jnp.asarray(u2))
    got = tenv.environment_sample(light, torch.tensor(u2))
    np.testing.assert_allclose(got.direction.numpy(),
                               np.asarray(ref.direction), rtol=RTOL,
                               atol=1e-5)
    # pdf = cell / sinθ with sinθ = sqrt(1 − y²), which cancels towards the
    # poles: all within 1e-3 there, 99.5% within 1e-5.
    assert_close_f32(got.pdf.numpy(), np.asarray(ref.pdf), rtol=RTOL,
                     atol=0.0)
    np.testing.assert_allclose(got.radiance.numpy(),
                               np.asarray(ref.radiance), rtol=RTOL,
                               atol=2e-4)
    np.testing.assert_array_equal(got.distance.numpy(),
                                  np.asarray(ref.distance))
    assert not bool(got.is_delta.any())
    # A sample's pdf is the pdf of its own direction.
    np.testing.assert_allclose(
        tenv.environment_pdf(light, got.direction).numpy()[got.pdf > 0],
        got.pdf.numpy()[got.pdf > 0], rtol=1e-3)


@pytest.mark.parametrize("name, count", [("small", 1024), ("tall", 256),
                                         ("small", 1)])
def test_presampled_pool_matches_jax(lights, name, count):
    jlight, light = lights[name]
    ref = jenv.presample_environment(jlight, count)
    got = tenv.presample_environment(light, count)
    assert got.sample_count == ref.sample_count == count
    assert got.nee_enabled == ref.nee_enabled == (count > 1)
    np.testing.assert_allclose(got.directions.numpy(),
                               np.asarray(ref.directions), rtol=RTOL,
                               atol=1e-5)
    assert_close_f32(got.pdfs.numpy(), np.asarray(ref.pdfs), rtol=RTOL,
                     atol=0.0)
    np.testing.assert_allclose(got.radiances.numpy(),
                               np.asarray(ref.radiances), rtol=RTOL,
                               atol=2e-4)
    rng = np.random.default_rng(17)
    u = rng.uniform(size=500).astype(np.float32)
    u[:3] = [0.0, 0.9999999, 1.0]
    rs = jenv.presampled_environment_sample(ref, jnp.asarray(u))
    gs = tenv.presampled_environment_sample(got, torch.tensor(u))
    np.testing.assert_allclose(gs.direction.numpy(), np.asarray(rs.direction),
                               rtol=RTOL, atol=1e-5)
    assert_close_f32(gs.pdf.numpy(), np.asarray(rs.pdf), rtol=RTOL, atol=0.0)
    np.testing.assert_array_equal(gs.distance.numpy(),
                                  np.asarray(rs.distance))


def test_presample_needs_a_power_of_two(lights):
    with pytest.raises(ValueError, match="power of two"):
        tenv.presample_environment(lights["small"][1], 100)


def test_pool_is_weighted_by_its_pdf(lights):
    """Σ radiance · |n·d| / pdf over the pool estimates the map's
    irradiance: the pool carries pdfs that belong to its directions."""
    _, light = lights["tall"]
    pool = tenv.presample_environment(light, 4096)
    up = pool.directions[:, 1].clamp_min(0.0)
    est = (pool.radiances * (up / pool.pdfs.clamp_min(1e-12))[:, None]
           )[pool.pdfs > 0].sum(0) / 4096
    rng = np.random.default_rng(18)
    d = rng.normal(size=(200000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = torch.tensor(d)
    ref = (tenv.environment_evaluate(light, d)
           * d[:, 1].clamp_min(0.0)[:, None]).mean(0) * 4 * np.pi
    np.testing.assert_allclose(est.numpy(), ref.numpy(), rtol=0.05)


def test_srgb_to_linear_matches_jax():
    c = np.linspace(0.0, 1.0, 257, dtype=np.float32)
    np.testing.assert_allclose(tcolor.srgb_to_linear(torch.tensor(c)).numpy(),
                               np.asarray(jcolor.srgb_to_linear(c)),
                               rtol=1e-6, atol=1e-9)
    assert float(tcolor.srgb_to_linear(1 / 255.0)) == pytest.approx(
        float(jcolor.srgb_to_linear(1 / 255.0)), rel=1e-6)
