"""The port's small modules against the JAX package's, on the CPU:
``math/statistics``, ``math/nelder_mead``, ``math/geometry2d3d``,
``bsdf/burley_sss``, ``apps/dev_analysis`` and ``utils/hostbuild``.

Deterministic float math is float64-anchored
(``torch_parity.assert_f64_anchored``). ``Statistics`` and ``nelder_mead``
are plain Python / numpy in both packages and must agree exactly. The
analyses' tables: the seeding analysis is bit-exact integer hashing, so
its numbers agree exactly; the SSS analysis within rtol 1e-5. The normals
analysis's errors are arccos of dot products a few float32 ulps below 1,
so they come in quanta of arccos(1 − 2⁻²⁴) = 0.0198°, and a lane whose
decoded vector differs by an ulp (torch's float32 ``sqrt`` is faithful,
not correctly rounded, on an AVX-512 host) moves by a quantum: the means
agree within 1e-4° (measured 2.2e-5°, about 9 lanes' quanta of 8,192, on
``reconstruct-z64``) and the maxima within one quantum.
"""

import numpy as np
import pytest
import torch

from bifrost3d_tpu.apps import dev_analysis as jax_dev
from bifrost3d_tpu.bsdf import burley_sss as jax_sss
from bifrost3d_tpu.math import geometry2d3d as jax_geo
from bifrost3d_tpu.math.nelder_mead import nelder_mead as jax_nelder_mead
from bifrost3d_tpu.math.statistics import Statistics as JaxStatistics

from bifrost3d_tpu_torch.apps import dev_analysis
from bifrost3d_tpu_torch.bsdf import burley_sss
from bifrost3d_tpu_torch.math import geometry2d3d as geo
from bifrost3d_tpu_torch.math.nelder_mead import nelder_mead
from bifrost3d_tpu_torch.math.statistics import Statistics
from bifrost3d_tpu_torch.utils.hostbuild import host_build
from torch_parity import assert_f64_anchored

CPU = torch.device("cpu")


# -- Statistics, Nelder-Mead -------------------------------------------------

def test_statistics_match_jax():
    rng = np.random.default_rng(0)
    a, b = rng.normal(3.0, 2.0, 1000), rng.uniform(-5.0, 1.0, 377)
    for values in (a, b, []):
        got, want = Statistics.of(values), JaxStatistics.of(values)
        assert (got.count, got.mean, got.variance, got.minimum, got.maximum) \
            == (want.count, want.mean, want.variance, want.minimum,
                want.maximum)
    got = Statistics.of(a).merge(Statistics.of(b))
    want = JaxStatistics.of(a).merge(JaxStatistics.of(b))
    assert (got.mean, got.variance, got.standard_deviation) == \
        (want.mean, want.variance, want.standard_deviation)
    np.testing.assert_allclose(got.mean, np.concatenate([a, b]).mean(),
                               rtol=1e-12)
    np.testing.assert_allclose(got.variance, np.concatenate([a, b]).var(),
                               rtol=1e-12)
    assert Statistics().merge(Statistics()).count == 0


def _rosenbrock(p):
    return (1.0 - p[0]) ** 2 + 100.0 * (p[1] - p[0] ** 2) ** 2


def test_nelder_mead_matches_jax():
    got = nelder_mead(_rosenbrock, [-1.2, 1.0], max_iterations=400)
    want = jax_nelder_mead(_rosenbrock, [-1.2, 1.0], max_iterations=400)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_allclose(got[0], [1.0, 1.0], atol=2e-2)


# -- geometry2d3d -------------------------------------------------------------

def _rays(rng, n):
    o = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)


def test_ray_plane_matches_jax():
    rng = np.random.default_rng(1)
    o, d = _rays(rng, 4096)
    point = rng.uniform(-1, 1, (4096, 3)).astype(np.float32)
    direction = rng.normal(size=(4096, 3)).astype(np.float32)

    def run(mod):
        def f(o, d, point, direction):
            plane = mod.Plane.from_point_direction(point, direction)
            return mod.intersect_ray_plane(o, d, plane), plane.normal, plane.d
        return f
    assert_f64_anchored(run(geo), run(jax_geo), o, d, point, direction)


def test_ray_sphere_matches_jax():
    rng = np.random.default_rng(2)
    o, d = _rays(rng, 4096)
    center = rng.uniform(-1, 1, (4096, 3)).astype(np.float32)
    radius = rng.uniform(0.1, 1.5, 4096).astype(np.float32)
    assert_f64_anchored(geo.intersect_ray_sphere, jax_geo.intersect_ray_sphere,
                        o, d, center, radius)


def test_line_matches_jax():
    rng = np.random.default_rng(3)
    xs = rng.uniform(-1, 1, (64, 32)).astype(np.float32)
    ys = (0.7 * xs - 0.2 + rng.normal(0, 0.05, xs.shape)).astype(np.float32)
    p0 = rng.uniform(-1, 1, (256, 2)).astype(np.float32)
    p1 = p0 + rng.uniform(0.5, 1.0, (256, 2)).astype(np.float32)
    x = rng.uniform(-1, 1, 256).astype(np.float32)

    def run(mod):
        def f(xs, ys, p0, p1, x):
            fit, line = mod.Line.fit(xs, ys), mod.Line.through(p0, p1)
            return (fit.slope, fit.intercept, line.evaluate(x),
                    line.signed_distance(x, x))
        return f
    assert_f64_anchored(run(geo), run(jax_geo), xs, ys, p0, p1, x)


def test_rect():
    r = geo.Rect(1, 2, 30, 40)
    assert (r.offset, r.size) == (jax_geo.Rect(1, 2, 30, 40).offset,
                                  jax_geo.Rect(1, 2, 30, 40).size)


def test_image_sampling_matches_jax():
    rng = np.random.default_rng(4)
    image = rng.uniform(0, 1, (5, 7, 3)).astype(np.float32)
    volume = rng.uniform(0, 1, (4, 5, 6, 2)).astype(np.float32)
    u, v, w = (rng.uniform(-0.2, 1.2, 2048).astype(np.float32)
               for _ in range(3))
    assert_f64_anchored(geo.sample_bilinear, jax_geo.sample_bilinear,
                        image, u, v)
    assert_f64_anchored(geo.sample_trilinear, jax_geo.sample_trilinear,
                        volume, u, v, w)


# -- burley_sss ---------------------------------------------------------------

def test_burley_profile_matches_jax():
    rng = np.random.default_rng(5)
    r = rng.uniform(0.0, 5.0, (2048, 1)).astype(np.float32)
    d = rng.uniform(0.05, 2.0, (2048, 3)).astype(np.float32)
    assert_f64_anchored(burley_sss.evaluate_profile,
                        jax_sss.evaluate_profile, r, d)


@pytest.mark.parametrize("diffuse_light", [True, False])
def test_burley_parameters_and_evaluate_match_jax(diffuse_light):
    rng = np.random.default_rng(6)
    albedo = rng.uniform(0, 1, (1024, 3)).astype(np.float32)
    mfp = rng.uniform(0.1, 2.0, (1024, 3)).astype(np.float32)
    po, pi = (rng.uniform(-1, 1, (1024, 3)).astype(np.float32)
              for _ in range(2))

    def run(mod):
        def f(albedo, mfp, po, pi):
            p = mod.Parameters.create(albedo, mfp, diffuse_light)
            return p.diffuse_mean_free_path, mod.evaluate(p, po, pi)
        return f
    assert_f64_anchored(run(burley_sss), run(jax_sss), albedo, mfp, po, pi)


def test_burley_approximate_sampler_matches_jax():
    rng = np.random.default_rng(7)
    u = rng.uniform(0, 1, 4096).astype(np.float32)
    d = rng.uniform(0.1, 2.0, 4096).astype(np.float32)
    assert_f64_anchored(burley_sss.sample_diffusion_profile_approximation,
                        jax_sss.sample_diffusion_profile_approximation, u, d)


def test_burley_exact_sampler_matches_jax():
    """The exact inverse CDF cancels near radius 0 (c ≈ 4u inside
    log2(c / 4u)): the port evaluates it in float64 (JAX's float32 error is
    its bound, as everywhere)."""
    rng = np.random.default_rng(7)
    u = rng.uniform(0, 1, 4096).astype(np.float32)
    d = rng.uniform(0.1, 2.0, 4096).astype(np.float32)
    assert_f64_anchored(burley_sss.sample_diffusion_profile,
                        jax_sss.sample_diffusion_profile, u, d)
    radius, rcp_pdf = burley_sss.sample_diffusion_profile(torch.tensor(u),
                                                          torch.tensor(d))
    assert radius.dtype == rcp_pdf.dtype == torch.float32


# -- dev_analysis -------------------------------------------------------------

def test_seeding_analysis_matches_jax():
    got = dev_analysis.seeding_analysis(32, 24, 5, device=CPU)
    want = jax_dev.seeding_analysis(32, 24, 5)
    assert got.keys() == want.keys()
    for name in want:      # "uniform" has no error, so no correlation: NaN
        np.testing.assert_array_equal(list(got[name].values()),
                                      list(want[name].values()))


def test_normals_analysis_matches_jax():
    got = dev_analysis.normals_analysis(8192, device=CPU)
    want = jax_dev.normals_analysis(8192)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name]["mean_deg"],
                                   want[name]["mean_deg"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[name]["max_deg"],
                                   want[name]["max_deg"], rtol=0, atol=0.0199)


def test_sss_analysis_matches_jax():
    got = dev_analysis.sss_analysis(1 << 12, device=CPU)
    want = jax_dev.sss_analysis(1 << 12)
    assert got.keys() == want.keys()
    for name in want:
        for key, value in want[name].items():
            np.testing.assert_allclose(got[name][key], value, rtol=1e-5)


def test_dev_analysis_cli_on_the_cpu(capsys):
    out = dev_analysis.main(["sss", "--device", "cpu"])
    assert list(out) == ["sss"] and "exact-cdf" in capsys.readouterr().out


# -- host_build ---------------------------------------------------------------

def test_host_build_on_the_cpu():
    from bifrost3d_tpu_torch.apps.scenes import create_cornell_box

    made_on = []

    def build(scale):
        made_on.append(torch.empty(1).device)
        return {"not a tuple": 1}, (torch.ones(2) * scale, [torch.zeros(1)])

    out = host_build(build, device="cpu")(3.0)
    assert made_on == [CPU]
    assert torch.equal(out[1][0], torch.full((2,), 3.0))
    scene, cam = host_build(create_cornell_box, device="cpu")(device="cpu")
    ref, ref_cam = create_cornell_box(device="cpu")
    assert torch.equal(scene.tri_verts, ref.tri_verts)
    assert scene.tri_verts.device == CPU and cam.projection.device == CPU
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            host_build(build)(1.0)       # the card is the default target
