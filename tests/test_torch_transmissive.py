"""The Transmissive model's pieces against the JAX package: ``refract``,
the dielectric Fresnel, the VNDF, GGX transmission and the combined R+T
lobe, Lambert, Burley, the dielectric and Burley rho lookups, the thin
sheet and ``TransmissiveShading``.

Every float comparison is ``torch_parity.assert_f64_anchored``: the
float64 formulas agree with JAX's on every lane (rtol 1e-9), and the
port's float32 error stays within 2 × JAX's + 4 ulps. Bool outputs are
equal. Inputs are seeded numpy; the IORs cover both sides of a surface
(entering 1.2–2.5, leaving their inverses), and a quarter of the ``wo``
lie below the surface.
"""

import numpy as np
import pytest
import torch

from bifrost3d_tpu.bsdf import burley as jburley
from bifrost3d_tpu.bsdf import fresnel as jf
from bifrost3d_tpu.bsdf import ggx as jg
from bifrost3d_tpu.bsdf import lambert as jlambert
from bifrost3d_tpu.math import vec as jvec
from bifrost3d_tpu.sampling import distributions as jd
from bifrost3d_tpu.scene import materials as jmat
from bifrost3d_tpu.shading import fittings as jfit
from bifrost3d_tpu.shading import thin_sheet as jthin
from bifrost3d_tpu.shading.transmissive_shading import (
    TransmissiveShading as JTrans,
)

from bifrost3d_tpu_torch.bsdf import burley as tburley
from bifrost3d_tpu_torch.bsdf import fresnel as tf
from bifrost3d_tpu_torch.bsdf import ggx as tg
from bifrost3d_tpu_torch.bsdf import lambert as tlambert
from bifrost3d_tpu_torch.math import vec as tvec
from bifrost3d_tpu_torch.sampling import distributions as td
from bifrost3d_tpu_torch.scene import materials as tmat
from bifrost3d_tpu_torch.shading import fittings as tfit
from bifrost3d_tpu_torch.shading import thin_sheet as tthin
from bifrost3d_tpu_torch.shading.transmissive_shading import (
    TransmissiveShading as TTrans,
)
from torch_parity import assert_f64_anchored

N = 2048


def _unit(rng, lower_share):
    w = rng.normal(size=(N, 3)).astype(np.float32)
    w[:, 2] = np.abs(w[:, 2]) + 0.02
    w[: int(N * lower_share), 2] *= -1.0
    return (w / np.linalg.norm(w, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(21)
    roughness = rng.uniform(0.1, 1.0, size=N).astype(np.float32)
    roughness[:64] = 0.0                      # delta lobes
    ior = rng.uniform(1.2, 2.5, size=N).astype(np.float32)
    leaving = rng.uniform(size=N) < 0.3
    ior[leaving] = (1.0 / ior[leaving]).astype(np.float32)
    alpha = tg.alpha_from_roughness(torch.tensor(roughness)).numpy()
    return dict(
        wo=_unit(rng, 0.25), wi=_unit(rng, 0.5),
        u3=rng.uniform(0, 1, size=(N, 3)).astype(np.float32),
        roughness=roughness, alpha=alpha, ior=ior,
        tint=rng.uniform(0.05, 1.0, size=(N, 3)).astype(np.float32),
        specularity=rng.uniform(0.01, 0.2, size=N).astype(np.float32),
        cos=rng.uniform(0.0, 1.0, size=N).astype(np.float32),
        signed_cos=rng.uniform(-1.0, 1.0, size=N).astype(np.float32),
        thin=rng.uniform(size=N) < 0.5)


def test_refract_and_dielectric_fresnel(lanes):
    d = -lanes["wo"]
    n = np.broadcast_to(np.asarray([0.0, 0.0, 1.0], np.float32), d.shape)
    eta = (1.0 / lanes["ior"])[:, None].astype(np.float32)
    assert_f64_anchored(tvec.refract, jvec.refract, d, n.copy(), eta)
    _, tir = tvec.refract(torch.tensor(d), torch.tensor(n.copy()),
                          torch.tensor(eta))
    assert 0 < int(tir.sum()) < N          # both branches taken
    assert_f64_anchored(tf.dielectric_schlick_fresnel,
                        jf.dielectric_schlick_fresnel,
                        lanes["specularity"], lanes["cos"], lanes["ior"])


def test_vndf(lanes):
    """The rough lanes only: at alpha = MIN_ALPHA, where every caller
    takes the delta branch instead, the sampled pdf reaches 1.6e7 and its
    float64 value is conditioned at ~1e8, past the identity's 1e-9."""
    rough = lanes["roughness"] > 0.0
    wo = np.abs(lanes["wo"][rough])
    u2 = lanes["u3"][rough, :2]
    alpha = lanes["alpha"][rough]
    assert_f64_anchored(td.ggx_vndf_sample_halfway, jd.ggx_vndf_sample_halfway,
                        alpha, wo, u2)
    h = td.ggx_vndf_sample_halfway(torch.tensor(alpha), torch.tensor(wo),
                                   torch.tensor(u2)).numpy()
    assert_f64_anchored(td.ggx_vndf_pdf, jd.ggx_vndf_pdf, alpha, wo, h)
    assert_f64_anchored(td.ggx_vndf_sample, jd.ggx_vndf_sample, alpha, wo, u2)
    assert_f64_anchored(td._ggx_lambda, jd._ggx_lambda, alpha, wo)


def test_ggx_transmission_lobe(lanes):
    a, ior, wo, wi = lanes["alpha"], lanes["ior"], lanes["wo"], lanes["wi"]
    h = tg._transmission_halfway(torch.tensor(ior), torch.tensor(wo),
                                 torch.tensor(wi)).numpy()
    assert_f64_anchored(tg._transmission_halfway, jg._transmission_halfway,
                        ior, wo, wi)
    assert_f64_anchored(tg._transmission_pdf_scale, jg._transmission_pdf_scale,
                        ior, wo, wi, h)
    assert_f64_anchored(tg._refract_about, jg._refract_about, h, wo, ior)
    assert_f64_anchored(tg.t_evaluate, jg.t_evaluate, a, ior, wo, wi)
    assert_f64_anchored(tg.t_pdf, jg.t_pdf, a, ior, wo, wi)
    assert_f64_anchored(lambda *x: tuple(tg.t_evaluate_with_pdf(*x)),
                        lambda *x: tuple(jg.t_evaluate_with_pdf(*x)),
                        a, ior, wo, wi)
    assert_f64_anchored(lambda *x: tuple(tg.t_sample(*x)),
                        lambda *x: tuple(jg.t_sample(*x)),
                        a, ior, wo, lanes["u3"][:, :2])


def test_ggx_combined_lobe(lanes):
    a, s, ior = lanes["alpha"], lanes["specularity"], lanes["ior"]
    wo, wi, tint = lanes["wo"], lanes["wi"], lanes["tint"]
    assert_f64_anchored(tg._normalize_reflection_probability,
                        jg._normalize_reflection_probability, s, tint)
    for t in ((), (tint,)):
        assert_f64_anchored(tg.evaluate, jg.evaluate, a, s, ior, wo, wi, *t)
        assert_f64_anchored(tg.pdf, jg.pdf, a, s, ior, wo, wi, *t)
        assert_f64_anchored(lambda *x: tuple(tg.evaluate_with_pdf(*x)),
                            lambda *x: tuple(jg.evaluate_with_pdf(*x)),
                            a, s, ior, wo, wi, *t)
        assert_f64_anchored(lambda *x: tuple(tg.sample(*x)),
                            lambda *x: tuple(jg.sample(*x)),
                            a, s, ior, wo, lanes["u3"], *t)
    got = tg.sample(*(torch.tensor(x) for x in (a, s, ior, wo, lanes["u3"])))
    below = got.direction[:, 2] * torch.tensor(wo[:, 2]) < 0
    assert 0 < int(below.sum()) < N        # reflections and refractions


def test_lambert_and_burley(lanes):
    tint, r, wo, wi = lanes["tint"], lanes["roughness"], lanes["wo"], lanes["wi"]
    wo = np.abs(wo)
    u2 = lanes["u3"][:, :2]
    assert_f64_anchored(tlambert.pdf, jlambert.pdf, wo, wi)
    assert_f64_anchored(lambda *x: tuple(tlambert.evaluate_with_pdf(*x)),
                        lambda *x: tuple(jlambert.evaluate_with_pdf(*x)),
                        tint, wo, wi)
    assert_f64_anchored(lambda *x: tuple(tlambert.sample(*x)),
                        lambda *x: tuple(jlambert.sample(*x)), tint, wo, u2)
    assert_f64_anchored(tburley.evaluate_scalar, jburley.evaluate_scalar,
                        r, wo, wi)
    assert_f64_anchored(lambda *x: tuple(tburley.evaluate_with_pdf(*x)),
                        lambda *x: tuple(jburley.evaluate_with_pdf(*x)),
                        tint, r, wo, wi)
    assert_f64_anchored(lambda *x: tuple(tburley.sample(*x)),
                        lambda *x: tuple(jburley.sample(*x)), tint, r, wo, u2)


def test_rho_lookups(lanes):
    cos, r, ior = lanes["cos"], lanes["roughness"].copy(), lanes["ior"]
    r[64:72] = 1.0                              # the grid's far edge
    assert_f64_anchored(tfit.sample_burley_rho, jfit.sample_burley_rho, cos, r)
    assert_f64_anchored(tfit.sample_dielectric_ggx_rho,
                        jfit.sample_dielectric_ggx_rho, cos, r, ior)
    table = np.asarray(jfit.get_fittings().dielectric_dense)
    z = (np.arange(N) % table.shape[0]).astype(np.int32)
    assert_f64_anchored(
        lambda z, x, y: tfit._bilinear_2d_batch(torch.tensor(table), z, x, y),
        lambda z, x, y: jfit._bilinear_2d_batch(table, z, x, y), z, cos, r)
    # Exact grid points reproduce the table.
    g = torch.arange(16, dtype=torch.float32) / 15
    got = tfit._bilinear_2d_batch(torch.tensor(table),
                                  torch.full((16,), 3), g, torch.full((16,),
                                                                      7 / 15))
    np.testing.assert_allclose(got.numpy(), table[3, 7], rtol=1e-6)


def test_thin_sheet(lanes):
    cos, r, tint = lanes["cos"], lanes["roughness"], lanes["tint"]
    medium = np.abs(lanes["ior"]).clip(1.0, None).astype(np.float32)
    assert_f64_anchored(tthin.refracted_cos_theta, jthin.refracted_cos_theta,
                        cos, medium)
    assert_f64_anchored(
        lambda *x: tuple(tthin.smooth_thin_sheet_reflectance(*x)),
        lambda *x: tuple(jthin.smooth_thin_sheet_reflectance(*x)),
        lanes["signed_cos"], medium, tint)
    assert_f64_anchored(
        lambda *x: tuple(tthin.approx_thin_sheet_reflectance(*x)),
        lambda *x: tuple(jthin.approx_thin_sheet_reflectance(*x)),
        cos, r, medium, tint)


def _shading_args(lanes):
    return (lanes["tint"], lanes["roughness"], lanes["specularity"],
            lanes["signed_cos"], lanes["thin"])


def test_transmissive_shading(lanes):
    args = _shading_args(lanes)
    wo = lanes["wo"] * np.where(lanes["signed_cos"] < 0, -1.0, 1.0)[:, None]
    wo = wo.astype(np.float32)
    assert_f64_anchored(lambda *x: tuple(TTrans.create(*x)),
                        lambda *x: tuple(JTrans.create(*x)), *args)
    assert_f64_anchored(
        lambda *x: tuple(TTrans.create(*x[:5]).evaluate_with_pdf(*x[5:])),
        lambda *x: tuple(JTrans.create(*x[:5]).evaluate_with_pdf(*x[5:])),
        *args, np.abs(wo), lanes["wi"])
    assert_f64_anchored(
        lambda *x: tuple(TTrans.create(*x[:5]).sample(*x[5:])),
        lambda *x: tuple(JTrans.create(*x[:5]).sample(*x[5:])),
        *args, np.abs(wo), lanes["u3"])
    assert_f64_anchored(
        lambda *x: TTrans.create(*x[:5]).rho(x[5]),
        lambda *x: JTrans.create(*x[:5]).rho(x[5]), *args, lanes["cos"])


def test_material_constants():
    assert tmat.GLASS_IOR == jmat.GLASS_IOR
    assert tmat.AIR_IOR == jmat.AIR_IOR
    assert tmat.GLASS_SPECULARITY == jmat.GLASS_SPECULARITY
    assert tmat.GOLD_TINT == jmat.GOLD_TINT
    assert (tmat.transmissive((0.9, 0.5, 0.4), 0.15)
            == jmat.transmissive((0.9, 0.5, 0.4), 0.15))
    assert tfit.MIN_DENSE_IOR == jfit.MIN_DENSE_IOR
    assert tfit.MAX_LIGHT_IOR == jfit.MAX_LIGHT_IOR
