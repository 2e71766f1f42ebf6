"""One JAX-vs-port gate for every public function and class of the JAX
package that no other port test names.

The list was made by walking each ``bifrost3d_tpu`` module's top-level
public ``def`` and ``class`` and dropping those that a
``tests/test_torch_*.py`` test reaches by name (directly, through a helper
or a parametrised table of its file). Each name left is one case of
``CASES`` below, keyed ``module.name`` as in the JAX package;
``tests/test_torch_imports.py`` reads the keys and fails when a public JAX
function is neither here nor in its list of functions covered elsewhere.

- Deterministic float math goes through
  ``torch_parity.assert_f64_anchored``: the port's float64 formula equals
  JAX's on every lane (rtol 1e-9), and its float32 error is within 2 ×
  JAX's + 4 ulps. A case that cannot run in float64 says why and keeps
  ``assert_close_f32``.
- Integer and boolean outputs are bit-exact.
- Data classes are held by their fields and their constructors' outputs.

The stochastic renderers, the datamodel managers and the host-side
classes are in ``test_torch_public_parity_frames.py``, which adds its
cases to the same list. Inputs come from numpy, seeded per case.
"""

import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per test worker)

from bifrost3d_tpu.bsdf import fresnel as jfr
from bifrost3d_tpu.bsdf import ggx as jggx
from bifrost3d_tpu.bsdf import types as jbt
from bifrost3d_tpu.diff import edge_grad as jeg
from bifrost3d_tpu.diff import render_grad as jrg
from bifrost3d_tpu.lights import analytic as jan
from bifrost3d_tpu.lights import types as jlt
from bifrost3d_tpu.math import color as jcol
from bifrost3d_tpu.math import quaternion as jq
from bifrost3d_tpu.math import transform as jtr
from bifrost3d_tpu.math import vec as jvec
from bifrost3d_tpu.post import tonemap as jtm
from bifrost3d_tpu.sampling import distributions as jd
from bifrost3d_tpu.sampling import sobol as jsob
from bifrost3d_tpu.scene import camera as jcam
from bifrost3d_tpu.scene import media as jmed
from bifrost3d_tpu.scene import render_scene as jrs
from bifrost3d_tpu.scene import spheres as jsph
from bifrost3d_tpu.shading import default_shading as jds
from bifrost3d_tpu.shading import diffuse_shading as jdif
from bifrost3d_tpu.shading import thin_sheet as jts

from bifrost3d_tpu_torch.bsdf import fresnel as tfr
from bifrost3d_tpu_torch.bsdf import ggx as tggx
from bifrost3d_tpu_torch.bsdf import types as tbt
from bifrost3d_tpu_torch.diff import edge_grad as teg
from bifrost3d_tpu_torch.diff import render_grad as trg
from bifrost3d_tpu_torch.lights import analytic as tan
from bifrost3d_tpu_torch.lights import types as tlt
from bifrost3d_tpu_torch.math import color as tcol
from bifrost3d_tpu_torch.math import quaternion as tq
from bifrost3d_tpu_torch.math import transform as ttr
from bifrost3d_tpu_torch.math import vec as tvec
from bifrost3d_tpu_torch.post import tonemap as ttm
from bifrost3d_tpu_torch.sampling import distributions as td
from bifrost3d_tpu_torch.sampling import sobol as tsob
from bifrost3d_tpu_torch.scene import camera as tcam
from bifrost3d_tpu_torch.scene import media as tmed
from bifrost3d_tpu_torch.scene import render_scene as trs
from bifrost3d_tpu_torch.scene import spheres as tsph
from bifrost3d_tpu_torch.shading import default_shading as tds
from bifrost3d_tpu_torch.shading import diffuse_shading as tdif
from bifrost3d_tpu_torch.shading import thin_sheet as tts
from torch_parity import assert_close_f32, assert_f64_anchored

N = 2048
CASES = {}


def case(name):
    """Register a case under the JAX name ``module.name`` it holds."""
    def register(fn):
        assert name not in CASES, name
        CASES[name] = fn
        return fn
    return register


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _unit(rng, n, upper=False):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    if upper:
        v[:, 2] = np.abs(v[:, 2]) + 1e-3
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v.astype(np.float32)


def _uniform(rng, lo, hi, shape=N):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _close_f32(port, ref):
    """Every float32 leaf of two output trees with ``assert_close_f32``."""
    port = torch.utils._pytree.tree_leaves(port)
    ref = [np.asarray(v) for v in jax.tree_util.tree_leaves(ref)]
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert a.dtype == torch.float32 and b.dtype == np.float32
        assert_close_f32(a.numpy(), b)


def _same_fields(port_cls, jax_cls):
    assert port_cls._fields == jax_cls._fields


# -- bsdf ------------------------------------------------------------------------

@case("bsdf.fresnel.conductor_specularity")
def _conductor_specularity(name):
    rng = _rng(name)
    assert_f64_anchored(tfr.conductor_specularity, jfr.conductor_specularity,
                        _uniform(rng, 1.0, 2.0), _uniform(rng, 0.1, 3.0),
                        _uniform(rng, 0.0, 5.0))


@case("bsdf.fresnel.dielectric_ior_from_specularity")
def _dielectric_ior_from_specularity(name):
    assert_f64_anchored(tfr.dielectric_ior_from_specularity,
                        jfr.dielectric_ior_from_specularity,
                        _uniform(_rng(name), 0.0, 0.9))


@case("bsdf.fresnel.conductor_ior_from_specularity")
def _conductor_ior_from_specularity(name):
    rng = _rng(name)
    assert_f64_anchored(tfr.conductor_ior_from_specularity,
                        jfr.conductor_ior_from_specularity,
                        _uniform(rng, 0.01, 0.99), _uniform(rng, 0.0, 5.0))


@case("bsdf.ggx.roughness_from_alpha")
def _roughness_from_alpha(name):
    assert_f64_anchored(tggx.roughness_from_alpha, jggx.roughness_from_alpha,
                        _uniform(_rng(name), 0.0, 1.0))


@case("bsdf.ggx.effectively_smooth")
def _effectively_smooth(name):
    alpha = _uniform(_rng(name), 0.0, 2e-4)
    alpha[:4] = (0.0, 1e-4, np.nextafter(np.float32(1e-4), 1), 1.0)
    got = tggx.effectively_smooth(torch.tensor(alpha)).numpy()
    want = np.asarray(jggx.effectively_smooth(jnp.asarray(alpha)))
    assert got.dtype == want.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


def _ggx_args(rng):
    wo = _unit(rng, N, upper=True)
    wi = _unit(rng, N)          # both hemispheres: the masks are held too
    return _uniform(rng, 0.0, 1.0), wo, wi


@case("bsdf.ggx.height_correlated_g")
def _height_correlated_g(name):
    alpha, wo, wi = _ggx_args(_rng(name))
    wi[:, 2] = np.abs(wi[:, 2]) + 1e-3
    assert_f64_anchored(tggx.height_correlated_g, jggx.height_correlated_g,
                        np.maximum(alpha, 1e-3), wo, wi)


@case("bsdf.ggx.r_evaluate")
def _r_evaluate(name):
    rng = _rng(name)
    alpha, wo, wi = _ggx_args(rng)
    alpha[:64] = 0.0            # effectively smooth: zero
    assert_f64_anchored(tggx.r_evaluate, jggx.r_evaluate, alpha,
                        _uniform(rng, 0.02, 1.0, (N, 3)), wo, wi)


@case("bsdf.ggx.r_pdf")
def _r_pdf(name):
    alpha, wo, wi = _ggx_args(_rng(name))
    alpha[:64] = 0.0
    assert_f64_anchored(tggx.r_pdf, jggx.r_pdf, alpha, wo, wi)


@case("bsdf.types.BSDFResponse")
def _bsdf_response(name):
    """Its fields, and the response a shading model's evaluate_with_pdf
    constructs."""
    _same_fields(tbt.BSDFResponse, jbt.BSDFResponse)
    rng = _rng(name)

    def run(dif, bt):
        def fn(tint, roughness, wo, wi):
            out = dif.DiffuseShading.create(tint, roughness).evaluate_with_pdf(
                wo, wi)
            assert type(out) is bt.BSDFResponse
            return out
        return fn
    assert_f64_anchored(run(tdif, tbt), run(jdif, jbt),
                        _uniform(rng, 0.0, 1.0, (N, 3)),
                        _uniform(rng, 0.0, 1.0), _unit(rng, N, upper=True),
                        _unit(rng, N))


# -- diff --------------------------------------------------------------------------

def _sphere_table(rng, n=8):
    """``n`` spheres in a 10-unit box, a quarter of them emissive."""
    emission = rng.uniform(0.5, 4.0, (n, 3)) * (rng.uniform(size=(n, 1)) < 0.5)
    return dict(position=rng.uniform(-5, 5, (n, 3)).astype(np.float32),
                radius=rng.uniform(0.5, 2.0, n).astype(np.float32),
                emission=emission.astype(np.float32),
                color=rng.uniform(0, 1, (n, 3)).astype(np.float32),
                bsdf=np.zeros(n, np.int32),
                medium_sigma_t=np.zeros(n, np.float32),
                medium_albedo=np.zeros(n, np.float32),
                medium_g=np.zeros(n, np.float32))


@case("diff.edge_grad.first_hit_emission")
def _first_hit_emission(name):
    rng = _rng(name)
    table = _sphere_table(rng)
    origin = rng.uniform(-8, 8, (N, 3)).astype(np.float32)
    # Aim at a sphere's centre, off by up to its radius: hits, misses and
    # occlusions, few grazing rays.
    aim = table["position"][rng.integers(0, 8, N)] + _unit(rng, N) * 1.5
    direction = aim - origin
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)

    def run(sph, eg):
        return lambda t, o, d: eg.first_hit_emission(sph.SphereScene(**t),
                                                     o, d)
    assert_f64_anchored(run(tsph, teg), run(jsph, jeg), table, origin,
                        direction)


@case("diff.render_grad.image_l2_loss")
def _image_l2_loss(name):
    rng = _rng(name)
    assert_f64_anchored(trg.image_l2_loss, jrg.image_l2_loss,
                        _uniform(rng, 0.0, 2.0, (16, 12, 3)),
                        _uniform(rng, 0.0, 2.0, (16, 12, 3)))


# -- lights ------------------------------------------------------------------------

def _sphere_light_args(rng):
    return (rng.uniform(-2, 2, (N, 3)).astype(np.float32),
            _uniform(rng, 0.05, 0.8),
            _uniform(rng, 1.0, 50.0, (N, 3)),
            rng.uniform(-3, 3, (N, 3)).astype(np.float32))


@case("lights.analytic.sphere_light_sample")
def _sphere_light_sample(name):
    rng = _rng(name)
    position, radius, power, lit = _sphere_light_args(rng)
    radius[:32] = 0.0           # point lights
    assert_f64_anchored(tan.sphere_light_sample, jan.sphere_light_sample,
                        position, radius, power, lit,
                        _uniform(rng, 0.0, 1.0, (N, 2)))


@case("lights.analytic.sphere_light_pdf")
def _sphere_light_pdf(name):
    rng = _rng(name)
    position, radius, _, lit = _sphere_light_args(rng)
    assert_f64_anchored(tan.sphere_light_pdf, jan.sphere_light_pdf,
                        position, radius, lit, _unit(rng, N))


@case("lights.analytic.sphere_light_evaluate")
def _sphere_light_evaluate(name):
    position, radius, power, lit = _sphere_light_args(_rng(name))
    assert_f64_anchored(tan.sphere_light_evaluate, jan.sphere_light_evaluate,
                        position, radius, power, lit)


def _spot_args(rng):
    """position, radius, light_dir, cos_angle, power, lit_position: lit
    points below a downward spot, inside and outside its cone."""
    position = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    position[:, 1] += 3.0
    light_dir = _unit(rng, N)
    light_dir[:, 1] = -np.abs(light_dir[:, 1]) - 1.0
    light_dir /= np.linalg.norm(light_dir, axis=-1, keepdims=True)
    lit = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    lit[:, 1] = rng.uniform(-1, 0.5, N)
    return (position, _uniform(rng, 0.0, 0.5), light_dir,
            _uniform(rng, 0.3, 0.95), _uniform(rng, 1.0, 50.0, (N, 3)), lit)


def _toward(rng, position, lit):
    d = position - lit + rng.normal(size=lit.shape) * 0.3
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@case("lights.analytic.spot_light_evaluate")
def _spot_light_evaluate(name):
    rng = _rng(name)
    position, radius, light_dir, cos_angle, power, lit = _spot_args(rng)
    assert_f64_anchored(tan.spot_light_evaluate, jan.spot_light_evaluate,
                        position, radius, light_dir, cos_angle, power, lit,
                        _toward(rng, position, lit))


@case("lights.analytic.spot_light_sample")
def _spot_light_sample(name):
    rng = _rng(name)
    args = list(_spot_args(rng))
    args[1][:32] = 0.0          # point spots
    assert_f64_anchored(tan.spot_light_sample, jan.spot_light_sample, *args,
                        _uniform(rng, 0.0, 1.0, (N, 2)))


@case("lights.analytic.spot_light_pdf")
def _spot_light_pdf(name):
    rng = _rng(name)
    position, radius, light_dir, cos_angle, _, lit = _spot_args(rng)
    assert_f64_anchored(tan.spot_light_pdf, jan.spot_light_pdf, position,
                        radius, light_dir, cos_angle, lit,
                        _toward(rng, position, lit))


@case("lights.analytic.directional_light_sample")
def _directional_light_sample(name):
    rng = _rng(name)

    def run(an):
        return lambda d, r: an.directional_light_sample(d, r, (N,))
    assert_f64_anchored(run(tan), run(jan), _unit(rng, 1)[0],
                        _uniform(rng, 0.5, 4.0, 3))


@case("lights.types.LightSample")
def _light_sample(name):
    """Its fields, and the sample a light's sampler constructs."""
    _same_fields(tlt.LightSample, jlt.LightSample)
    rng = _rng(name)
    position, radius, power, lit = _sphere_light_args(rng)

    def run(an, lt):
        def fn(*args):
            out = an.sphere_light_sample(*args)
            assert type(out) is lt.LightSample
            return out
        return fn
    assert_f64_anchored(run(tan, tlt), run(jan, jlt), position, radius,
                        power, lit, _uniform(rng, 0.0, 1.0, (N, 2)))


# -- math --------------------------------------------------------------------------

@case("math.color.luminance")
def _luminance(name):
    assert_f64_anchored(tcol.luminance, jcol.luminance,
                        _uniform(_rng(name), 0.0, 4.0, (N, 3)))


@case("math.quaternion.quat_normalize")
def _quat_normalize(name):
    rng = _rng(name)
    assert_f64_anchored(tq.quat_normalize, jq.quat_normalize,
                        (rng.normal(size=(N, 4)) * 3).astype(np.float32))


@case("math.quaternion.quat_conjugate")
def _quat_conjugate(name):
    assert_f64_anchored(tq.quat_conjugate, jq.quat_conjugate,
                        _unit_quats(_rng(name), N))


@case("math.quaternion.quat_look_in")
def _quat_look_in(name):
    """The port casts the direction (and its default up) to float32, as
    JAX does, so there is no float64 run: ``assert_close_f32``."""
    rng = _rng(name)
    direction = _unit(rng, N)
    direction[np.abs(direction[:, 1]) > 0.95, 1] = 0.5   # not along up
    up = _unit(rng, 1)[0]
    _close_f32(tq.quat_look_in(torch.tensor(direction)),
               jq.quat_look_in(jnp.asarray(direction)))
    _close_f32(tq.quat_look_in(torch.tensor(direction), torch.tensor(up)),
               jq.quat_look_in(jnp.asarray(direction), jnp.asarray(up)))


def _transform_args(rng, n=N):
    return (rng.uniform(-4, 4, (n, 3)).astype(np.float32),
            _unit_quats(rng, n), _uniform(rng, 0.25, 3.0, n))


@case("math.transform.transform_point")
def _transform_point(name):
    rng = _rng(name)

    def run(tr):
        return lambda t, r, s, p: tr.transform_point(tr.Transform(t, r, s), p)
    assert_f64_anchored(run(ttr), run(jtr), *_transform_args(rng),
                        rng.uniform(-5, 5, (N, 3)).astype(np.float32))


@case("math.transform.transform_vector")
def _transform_vector(name):
    rng = _rng(name)

    def run(tr):
        return lambda t, r, s, v: tr.transform_vector(tr.Transform(t, r, s),
                                                      v)
    assert_f64_anchored(run(ttr), run(jtr), *_transform_args(rng),
                        rng.uniform(-5, 5, (N, 3)).astype(np.float32))


@case("math.transform.transform_inverse")
def _transform_inverse(name):
    def run(tr):
        return lambda t, r, s: tr.transform_inverse(tr.Transform(t, r, s))
    assert_f64_anchored(run(ttr), run(jtr), *_transform_args(_rng(name)))


@case("math.transform.transform_look_at")
def _transform_look_at(name):
    """One camera-style transform per eye. Its rotation comes from
    ``quat_look_in`` and its scale is a float32 1, so there is no float64
    run: ``assert_close_f32``."""
    rng = _rng(name)
    for _ in range(8):
        eye = rng.uniform(-5, 5, 3).astype(np.float32)
        target = rng.uniform(-1, 1, 3).astype(np.float32)
        _close_f32(ttr.transform_look_at(torch.tensor(eye),
                                         torch.tensor(target)),
                   jtr.transform_look_at(jnp.asarray(eye),
                                         jnp.asarray(target)))


@case("math.vec.length_squared")
def _length_squared(name):
    assert_f64_anchored(tvec.length_squared, jvec.length_squared,
                        _uniform(_rng(name), -3.0, 3.0, (N, 3)))


@case("math.vec.length")
def _length(name):
    v = _uniform(_rng(name), -3.0, 3.0, (N, 3))
    assert_f64_anchored(tvec.length, jvec.length, v)
    assert_f64_anchored(lambda x: tvec.length(x, keepdims=True),
                        lambda x: jvec.length(x, keepdims=True), v)


@case("math.vec.safe_rsqrt")
def _safe_rsqrt(name):
    x = _uniform(_rng(name), 0.0, 4.0)
    x[:8] = (0.0, 1e-21, 1e-20, 1e-19, 1e-30, 1.0, 4.0, 1e-10)
    assert_f64_anchored(tvec.safe_rsqrt, jvec.safe_rsqrt, x)


@case("math.vec.normalize")
def _normalize(name):
    v = _uniform(_rng(name), -3.0, 3.0, (N, 3))
    v[0] = 0.0                  # the zero vector stays zero
    assert_f64_anchored(tvec.normalize, jvec.normalize, v)


@case("math.vec.lerp")
def _lerp(name):
    rng = _rng(name)
    assert_f64_anchored(tvec.lerp, jvec.lerp, _uniform(rng, -2, 2, (N, 3)),
                        _uniform(rng, -2, 2, (N, 3)),
                        _uniform(rng, 0, 1, (N, 1)))


@case("math.vec.reflect")
def _reflect(name):
    rng = _rng(name)
    assert_f64_anchored(tvec.reflect, jvec.reflect, _unit(rng, N),
                        _unit(rng, N))


@case("math.vec.orthonormal_basis")
def _orthonormal_basis(name):
    n = _unit(_rng(name), N)
    n[:2] = ((0, 0, 1), (0, 0, -1))
    assert_f64_anchored(tvec.orthonormal_basis, jvec.orthonormal_basis, n)


# -- post, sampling ----------------------------------------------------------------

@case("post.tonemap.apply_tonemap")
def _apply_tonemap(name):
    """Every mode. Filmic and AgX multiply by float32 colour matrices in
    the port (JAX's are float32 too), so those two have no float64 run:
    ``assert_close_f32``."""
    color = _uniform(_rng(name), 0.0, 8.0, (N, 3))
    for mode in (jtm.TONEMAP_LINEAR, jtm.TONEMAP_KHRONOS_NEUTRAL):
        assert_f64_anchored(lambda c: ttm.apply_tonemap(c, mode),
                            lambda c: jtm.apply_tonemap(c, mode), color)
    for mode in (jtm.TONEMAP_FILMIC, jtm.TONEMAP_AGX):
        _close_f32(ttm.apply_tonemap(torch.tensor(color), mode),
                   jtm.apply_tonemap(jnp.asarray(color), mode))
    for bad in (ttm.apply_tonemap, jtm.apply_tonemap):
        with pytest.raises(ValueError, match="unknown tonemapping mode"):
            bad(color, 99)


@case("sampling.distributions.cone_pdf")
def _cone_pdf(name):
    c = _uniform(_rng(name), -1.0, 1.0)
    c[:2] = (1.0, np.nextafter(np.float32(1.0), 0))
    assert_f64_anchored(td.cone_pdf, jd.cone_pdf, c)


@case("sampling.distributions.cosine_hemisphere_pdf")
def _cosine_hemisphere_pdf(name):
    assert_f64_anchored(td.cosine_hemisphere_pdf, jd.cosine_hemisphere_pdf,
                        _uniform(_rng(name), 0.0, 1.0))


@case("sampling.distributions.henyey_greenstein_phase")
def _henyey_greenstein_phase(name):
    rng = _rng(name)
    assert_f64_anchored(td.henyey_greenstein_phase,
                        jd.henyey_greenstein_phase,
                        _uniform(rng, -0.9, 0.9), _uniform(rng, -1.0, 1.0))


@case("sampling.distributions.henyey_greenstein_sample")
def _henyey_greenstein_sample(name):
    """The port takes ``g`` as a number (one medium); JAX's as an array."""
    u2 = _uniform(_rng(name), 0.0, 1.0, (N, 2))
    for g in (-0.7, 0.0, 5e-4, 0.3, 0.9):
        assert_f64_anchored(lambda u: td.henyey_greenstein_sample(g, u),
                            lambda u: jd.henyey_greenstein_sample(g, u), u2)


@case("sampling.sobol.Dimension")
def _dimension(name):
    public = [k for k in vars(jsob.Dimension) if not k.startswith("_")]
    assert public == [k for k in vars(tsob.Dimension) if not k.startswith("_")]
    for k in public:
        assert getattr(tsob.Dimension, k) == getattr(jsob.Dimension, k), k


@case("sampling.sobol.sobol_sample_4d")
def _sobol_sample_4d(name):
    """Bit for bit: the port carries uint32 in int64."""
    rng = _rng(name)
    index = rng.integers(0, 2**32, 4096, dtype=np.uint64)
    seed = rng.integers(0, 2**32, 4096, dtype=np.uint64)
    index[:4] = (0, 1, 2**31, 2**32 - 1)
    got = tsob.sobol_sample_4d(torch.tensor(index.astype(np.int64)),
                               torch.tensor(seed.astype(np.int64))).numpy()
    want = np.asarray(jsob.sobol_sample_4d(
        jnp.asarray(index.astype(np.uint32)),
        jnp.asarray(seed.astype(np.uint32))))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# -- scene -------------------------------------------------------------------------

def _camera_leaves(rng):
    """A perspective camera as float arrays: translation, rotation, scale,
    projection, inverse projection (JAX builds it; both sides read it)."""
    cam = jcam.perspective_camera(eye=tuple(rng.uniform(-4, 4, 3)),
                                  target=tuple(rng.uniform(-0.5, 0.5, 3)),
                                  fov_radians=0.9, aspect=1.5)
    t = cam.transform
    return [np.asarray(a, np.float32) for a in (
        t.translation, t.rotation, t.scale, cam.projection,
        cam.inverse_projection)]


def _camera(cm, tr, t, r, s, proj, inv):
    return cm.PinholeCamera(tr.Transform(t, r, s), proj, inv)


@case("scene.camera.PinholeCamera")
def _pinhole_camera(name):
    """Its fields, and the camera ``perspective_camera`` constructs (from
    numbers: the port builds float32 tensors whatever its inputs, so no
    float64 run: ``assert_close_f32``)."""
    _same_fields(tcam.PinholeCamera, jcam.PinholeCamera)
    rng = _rng(name)
    for _ in range(4):
        eye = tuple(float(v) for v in rng.uniform(-5, 5, 3))
        target = tuple(float(v) for v in rng.uniform(-1, 1, 3))
        got = tcam.perspective_camera(eye, target, 0.8, 1.25, device="cpu")
        want = jcam.perspective_camera(eye, target, 0.8, 1.25)
        assert type(got) is tcam.PinholeCamera
        _close_f32(got, want)


@case("scene.camera.perspective_projection")
def _perspective_projection(name):
    """Numbers in, float32 matrices out on both sides (the port builds
    float32 tensors), so no float64 run: ``assert_close_f32``."""
    for near, far, fov, aspect in ((0.1, 1000.0, np.pi / 3, 1.0),
                                   (0.01, 50.0, 0.4, 16 / 9),
                                   (1.0, 2.0, 2.5, 0.5)):
        _close_f32(tcam.perspective_projection(near, far, fov, aspect,
                                               device="cpu"),
                   jcam.perspective_projection(near, far, fov, aspect))


@case("scene.camera.project_to_screen")
def _project_to_screen(name):
    rng = _rng(name)

    def run(cm, tr):
        return lambda cam, p: cm.project_to_screen(_camera(cm, tr, *cam), p)
    assert_f64_anchored(run(tcam, ttr), run(jcam, jtr), _camera_leaves(rng),
                        rng.uniform(-3, 3, (N, 3)).astype(np.float32))


@case("scene.camera.camera_rays")
def _camera_rays(name):
    rng = _rng(name)

    def run(cm, tr):
        return lambda cam, j: cm.camera_rays(_camera(cm, tr, *cam), 24, 16, j)
    assert_f64_anchored(run(tcam, ttr), run(jcam, jtr), _camera_leaves(rng),
                        _uniform(rng, 0.0, 1.0, (16, 24, 2)))

    # The default jitter is a float32 tensor in the port: no float64 run.
    leaves = _camera_leaves(rng)
    _close_f32(tcam.camera_rays(_camera(tcam, ttr, *map(torch.tensor,
                                                        leaves)), 24, 16),
               jcam.camera_rays(_camera(jcam, jtr, *map(jnp.asarray,
                                                        leaves)), 24, 16))


def _media(rng):
    return (_uniform(rng, 0.01, 8.0, (N, 3)), _uniform(rng, 1e-4, 2.0, (N, 3)))


@case("scene.media.MeasuredScatteringParameters")
def _measured_scattering(name):
    """Fields, properties and ``diffuse_albedo``; ``from_artistic`` casts
    its inputs to float32 in both packages, so it has no float64 run:
    ``assert_close_f32``."""
    _same_fields(tmed.MeasuredScatteringParameters,
                 jmed.MeasuredScatteringParameters)
    s, a = _media(_rng(name))

    def run(md):
        def fn(s, a):
            m = md.MeasuredScatteringParameters(s, a)
            return (m.attenuation_coefficient, m.mean_free_path,
                    m.single_scattering_albedo, m.diffuse_albedo(),
                    m.diffuse_albedo(1.5))
        return fn
    assert_f64_anchored(run(tmed), run(jmed), s, a)
    _close_f32(tmed.MeasuredScatteringParameters.from_artistic(
                   tmed.ArtisticScatteringParameters(torch.tensor(s),
                                                     torch.tensor(a))),
               jmed.MeasuredScatteringParameters.from_artistic(
                   jmed.ArtisticScatteringParameters(jnp.asarray(s),
                                                     jnp.asarray(a))))


@case("scene.media.ArtisticScatteringParameters")
def _artistic_scattering(name):
    """Fields and ``from_measured`` at two IORs (float64-anchored), and a
    round trip through the measured parameters (``from_artistic`` casts
    to float32: ``assert_close_f32``)."""
    _same_fields(tmed.ArtisticScatteringParameters,
                 jmed.ArtisticScatteringParameters)
    rng = _rng(name)

    def run(md):
        def fn(s, a):
            m = md.MeasuredScatteringParameters(s, a)
            return (md.ArtisticScatteringParameters.from_measured(m),
                    md.ArtisticScatteringParameters.from_measured(m, 1.5))
        return fn
    assert_f64_anchored(run(tmed), run(jmed), *_media(rng))
    albedo = _uniform(rng, 0.01, 0.99, (N, 3))
    mfp = _uniform(rng, 0.05, 5.0, (N, 3))

    def round_trip(md, arr):
        m = md.MeasuredScatteringParameters.from_artistic(
            md.ArtisticScatteringParameters(arr(albedo), arr(mfp)))
        return md.ArtisticScatteringParameters.from_measured(m)
    _close_f32(round_trip(tmed, torch.tensor), round_trip(jmed, jnp.asarray))


@case("scene.render_scene.corner_normals")
def _corner_normals(name):
    """Integer inputs (octahedral int16 normals, prim ids): both packages
    decode in float32 whatever the run, so no float64 run; the decode's
    arithmetic is allclose at 1e-6 with no outlier."""
    rng = _rng(name)
    normals_oct = rng.integers(-32767, 32768, (512, 3, 2)).astype(np.int16)
    prim = rng.integers(0, 512, (64, 32)).astype(np.int32)

    class Scene:
        pass
    port, ref = Scene(), Scene()
    port.tri_normals_oct = torch.tensor(normals_oct)
    ref.tri_normals_oct = jnp.asarray(normals_oct)
    got = trs.corner_normals(port, torch.tensor(prim)).numpy()
    want = np.asarray(jrs.corner_normals(ref, jnp.asarray(prim)))
    assert got.shape == want.shape == (64, 32, 3, 3)
    assert_close_f32(got, want, rtol=1e-6, atol=1e-6, share=1.0,
                     outlier_rtol=1e-6)


# -- shading -----------------------------------------------------------------------

@case("shading.default_shading.modulate_roughness_under_coat")
def _modulate_roughness_under_coat(name):
    rng = _rng(name)
    base = _uniform(rng, 0.0, 1.0)
    base[:2] = (1.0, 0.0)
    assert_f64_anchored(tds.modulate_roughness_under_coat,
                        jds.modulate_roughness_under_coat, base,
                        _uniform(rng, 0.0, 1.0))


@case("shading.diffuse_shading.DiffuseShading")
def _diffuse_shading(name):
    """create, evaluate_with_pdf, sample and rho."""
    _same_fields(tdif.DiffuseShading, jdif.DiffuseShading)
    rng = _rng(name)

    def run(dif):
        def fn(tint, roughness, wo, wi, u3, cos):
            s = dif.DiffuseShading.create(tint, roughness)
            return (s, s.evaluate_with_pdf(wo, wi), s.sample(wo, u3),
                    s.rho(cos))
        return fn
    assert_f64_anchored(run(tdif), run(jdif),
                        _uniform(rng, 0.0, 1.0, (N, 3)),
                        _uniform(rng, 0.0, 1.0), _unit(rng, N, upper=True),
                        _unit(rng, N), _uniform(rng, 0.0, 1.0, (N, 3)),
                        _uniform(rng, 0.0, 1.0))


@case("shading.thin_sheet.ThinSheetThroughput")
def _thin_sheet_throughput(name):
    """Its fields, and what smooth_thin_sheet_reflectance constructs (past
    the critical angle too)."""
    _same_fields(tts.ThinSheetThroughput, jts.ThinSheetThroughput)
    rng = _rng(name)

    def run(ts):
        def fn(cos, tint):
            out = ts.smooth_thin_sheet_reflectance(cos, 1.5, tint)
            assert type(out) is ts.ThinSheetThroughput
            return out
        return fn
    assert_f64_anchored(run(tts), run(jts), _uniform(rng, -1.0, 1.0),
                        _uniform(rng, 0.0, 1.0, (N, 3)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_public_function_matches_jax(name):
    CASES[name](name)


# Constants whose values are not the JAX package's by design.
_OWN_VALUES = {
    # The port's default lies inside its own checkout
    # (assets/Shaderball.gltf), so that nothing around the checkout decides
    # the scene; JAX's is an absolute path outside it. Both read
    # BIFROST_SHADERBALL first.
    "apps.scenes.SHADERBALL_PATH",
}


def test_public_constants_equal_jax():
    """Every public upper-case constant of the JAX package that the port
    has holds JAX's value: numbers and strings equal, tuples element for
    element, a numpy scalar or array in JAX's dtype, dicts key for key."""
    import importlib
    from test_torch_imports import TPU_ONLY, _jax_public

    compared = 0
    for key, kind in sorted(_jax_public().items()):
        if kind != "const" or key in TPU_ONLY or key in _OWN_VALUES:
            continue
        module, name = key.rsplit(".", 1)
        module = module.removesuffix("__init__").rstrip(".")
        want = getattr(importlib.import_module(
            ".".join(filter(None, ("bifrost3d_tpu", module)))), name)
        got = getattr(importlib.import_module(
            ".".join(filter(None, ("bifrost3d_tpu_torch", module)))), name)
        if isinstance(want, dict):
            assert sorted(got) == sorted(want), key
        elif isinstance(want, (np.floating, np.ndarray)):
            np.testing.assert_array_equal(np.asarray(got, want.dtype), want,
                                          err_msg=key)
        elif isinstance(want, (int, float, str, tuple)):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                          err_msg=key)
        else:
            continue            # a type alias or a type variable
        compared += 1
    assert compared >= 110, compared
