"""The port's BSDFs, Default shading model and rho lookups against JAX.

Inputs are made with numpy (seeded) and fed to both packages; outputs are
float32 allclose at rtol 1e-5, atol 1e-6, with the ill-conditioned-lane
allowance of ``torch_parity.assert_close_f32``. Delta flags are equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bifrost3d_tpu.bsdf import fresnel as jf
from bifrost3d_tpu.bsdf import ggx as jg
from bifrost3d_tpu.bsdf import oren_nayar as jon
from bifrost3d_tpu.shading import fittings as jfit
from bifrost3d_tpu.shading.default_shading import DefaultShading as JDefault

from bifrost3d_tpu_torch.bsdf import fresnel as tf
from bifrost3d_tpu_torch.bsdf import ggx as tg
from bifrost3d_tpu_torch.bsdf import oren_nayar as ton
from bifrost3d_tpu_torch.shading import fittings as tfit
from bifrost3d_tpu_torch.shading.default_shading import DefaultShading as TDefault
from torch_parity import assert_close_f32, assert_f64_anchored

N = 4096


def _hemisphere(rng, lower_share=0.0):
    w = rng.normal(size=(N, 3)).astype(np.float32)
    w[:, 2] = np.abs(w[:, 2]) + 0.02
    w[: int(N * lower_share), 2] *= -1.0
    return (w / np.linalg.norm(w, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(5)
    # Rough lobes from roughness 0.2 (alpha 0.04) up — sharper float32
    # lobes amplify 1-ulp differences near their peak past 1e-3 — plus
    # smooth lanes that sample delta mirrors.
    roughness = rng.uniform(0.2, 1.0, size=N).astype(np.float32)
    roughness[:64] = 0.0
    coat = np.where(rng.uniform(size=N) < 0.5, 0.0,
                    rng.uniform(0.0, 1.0, size=N)).astype(np.float32)
    return dict(
        wo=_hemisphere(rng),
        wi=_hemisphere(rng, lower_share=0.1),
        u3=rng.uniform(0, 1, size=(N, 3)).astype(np.float32),
        roughness=roughness,
        tint=rng.uniform(0.0, 1.0, size=(N, 3)).astype(np.float32),
        specularity=rng.uniform(0.0, 1.0, size=N).astype(np.float32),
        metallic=rng.uniform(0.0, 1.0, size=N).astype(np.float32),
        coat=coat,
        coat_roughness=rng.uniform(0.0, 1.0, size=N).astype(np.float32),
        cos=rng.uniform(0.0, 1.0, size=N).astype(np.float32))


def _pair(inputs, *names):
    return ([torch.tensor(inputs[n]) for n in names],
            [jnp.asarray(inputs[n]) for n in names])


def _close(got, ref):
    if isinstance(got, tuple):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _close(g, r)
        return
    got, ref = got.numpy(), np.asarray(ref)
    if got.dtype == np.bool_:
        np.testing.assert_array_equal(got, ref)
    else:
        assert_close_f32(got, ref)


def test_fresnel(inputs):
    """Gate (torch_parity.assert_f64_anchored): the float64 formulas agree
    with JAX's on every lane, and the port's float32 error stays within
    2 × JAX's + 4 ulps. ``adjust_conductor_…`` cancels (``-b + sqrt(d)``):
    both packages' float32 values sit up to 1.9e-4 relative off float64."""
    spec, cos, tint = inputs["specularity"], inputs["cos"], inputs["tint"]
    assert_f64_anchored(tf.schlick_fresnel, jf.schlick_fresnel, spec, cos)
    assert_f64_anchored(lambda s: tf.dielectric_specularity(1.5, 1.0 + s),
                        lambda s: jf.dielectric_specularity(1.5, 1.0 + s),
                        spec)
    s = np.clip(spec, 0.0, 0.9999)
    assert_f64_anchored(
        lambda s: tf.adjust_dielectric_specularity_to_exterior_medium(1.5, s),
        lambda s: jf.adjust_dielectric_specularity_to_exterior_medium(1.5, s),
        s)
    t = np.clip(tint, 0.0, 0.9999)
    assert_f64_anchored(
        lambda t, z: tf.adjust_conductor_specularity_to_exterior_medium(
            1.5, t, z),
        lambda t, z: jf.adjust_conductor_specularity_to_exterior_medium(
            1.5, t, z),
        t, np.zeros_like(t))


def test_ggx_reflection(inputs):
    """Gate ``assert_f64_anchored``. alpha is computed once in float32 and
    handed to both sides as an input: JAX's ``r_sample`` casts it to
    float32, so float64 runs must start from the same float32 alpha."""
    r = inputs["roughness"]
    assert_f64_anchored(tg.alpha_from_roughness, jg.alpha_from_roughness, r)
    alpha = tg.alpha_from_roughness(torch.tensor(r)).numpy()
    lanes = (inputs["wo"], inputs["wi"])
    assert_f64_anchored(
        lambda a, s, wo, wi: tuple(tg.r_evaluate_with_pdf(a, s, wo, wi)),
        lambda a, s, wo, wi: tuple(jg.r_evaluate_with_pdf(a, s, wo, wi)),
        alpha, inputs["tint"], *lanes)
    assert_f64_anchored(
        lambda a, s, wo, wi: tuple(tg.r_evaluate_with_pdf(a, s, wo, wi)),
        lambda a, s, wo, wi: tuple(jg.r_evaluate_with_pdf(a, s, wo, wi)),
        alpha, np.asarray([0.04], np.float32), *lanes)
    assert_f64_anchored(
        lambda a, s, wo, u: tuple(tg.r_sample(a, s, wo, u)),
        lambda a, s, wo, u: tuple(jg.r_sample(a, s, wo, u)),
        alpha, inputs["tint"], inputs["wo"], inputs["u3"][:, :2])


def test_oren_nayar(inputs):
    (r, tint, wo, wi, u3), (jr, jtint, jwo, jwi, ju3) = _pair(
        inputs, "roughness", "tint", "wo", "wi", "u3")
    _close(tuple(ton.evaluate_with_pdf(tint, r, wo, wi)),
           tuple(jon.evaluate_with_pdf(jtint, jr, jwo, jwi)))
    _close(tuple(ton.sample(tint, r, wo, u3[:, :2])),
           tuple(jon.sample(jtint, jr, jwo, ju3[:, :2])))


def test_rho_lookups(inputs):
    (cos, r), (jcos, jr) = _pair(inputs, "cos", "roughness")
    _close(tfit.sample_ggx_rho(cos, r), jfit.sample_ggx_rho(jcos, jr))
    _close(tfit.sample_ggx_with_fresnel_rho(cos, r),
           jfit.sample_ggx_with_fresnel_rho(jcos, jr))
    # Exact grid points reproduce the table.
    table = tfit.get_fittings(torch.device("cpu")).ggx
    grid = torch.arange(32, dtype=torch.float32) / 31
    np.testing.assert_allclose(
        tfit.sample_ggx_rho(grid, torch.full((32,), 15 / 31)).numpy(),
        table[15].numpy(), rtol=1e-6)


@pytest.fixture(scope="module")
def shading(inputs):
    names = ("tint", "roughness", "specularity", "metallic", "coat",
             "coat_roughness", "cos")
    t, j = _pair(inputs, *names)
    return TDefault.create(*t), JDefault.create(*j)


def test_default_shading_create(shading):
    port, ref = shading
    for field in TDefault._fields:
        _close(getattr(port, field), jnp.broadcast_to(
            getattr(ref, field), getattr(port, field).shape))
    _close(port.diffuse_probability, ref.diffuse_probability)


def test_default_shading_evaluate_with_pdf(shading, inputs):
    port, ref = shading
    (wo, wi), (jwo, jwi) = _pair(inputs, "wo", "wi")
    _close(tuple(port.evaluate_with_pdf(wo, wi)),
           tuple(ref.evaluate_with_pdf(jwo, jwi)))


_SHADING_INPUTS = ("tint", "roughness", "specularity", "metallic", "coat",
                   "coat_roughness", "cos")


def test_default_shading_sample(shading, inputs):
    """Gate ``assert_f64_anchored`` from the material inputs to the
    sample (the rho tables are float32 data, read in float64 by both)."""
    port, _ = shading
    args = [inputs[n] for n in _SHADING_INPUTS] + [inputs["wo"], inputs["u3"]]
    assert_f64_anchored(
        lambda *a: tuple(TDefault.create(*a[:7]).sample(a[7], a[8])),
        lambda *a: tuple(JDefault.create(*a[:7]).sample(a[7], a[8])), *args)
    got = port.sample(torch.tensor(inputs["wo"]), torch.tensor(inputs["u3"]))
    assert 0 < int(got.is_delta.sum()) < N   # both lobe kinds were drawn
