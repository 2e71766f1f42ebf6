"""GGX microfacet BSDF: reflection, transmission, and combined R+T.

Port of ``bifrost3d_tpu/bsdf/ggx.py``: Walter 07 with Schlick Fresnel,
height-correlated Smith G, bounded-VNDF reflection sampling and VNDF
transmission sampling. alpha = roughness², and ``MIN_ALPHA`` = 1e-4 is
effectively smooth (delta mirror / delta refraction). ``ior_i_over_o`` =
IOR of the transmitted side over the incident side, adjusted by the caller
to the hemisphere being hit.
"""

from __future__ import annotations

import torch

from benchmark.reference.frozen.bsdf.fresnel import (
    dielectric_schlick_fresnel,
    schlick_fresnel,
)
from benchmark.reference.frozen.bsdf.types import BSDFResponse, BSDFSample
from benchmark.reference.frozen.math.clip import maximum
from benchmark.reference.frozen.math.vec import gsafe, normalize
from benchmark.reference.frozen.sampling.distributions import (
    ggx_bounded_vndf_pdf,
    ggx_bounded_vndf_sample,
    ggx_lambda,
    ggx_ndf,
    ggx_vndf_pdf,
    ggx_vndf_sample_halfway,
)

MIN_ALPHA = 1e-4


def alpha_from_roughness(roughness):
    return maximum(roughness * roughness, MIN_ALPHA)


def roughness_from_alpha(alpha):
    return torch.sqrt(alpha)


def effectively_smooth(alpha):
    return alpha <= MIN_ALPHA


def height_correlated_g(alpha, wo, wi):
    """Height-correlated Smith masking-shadowing."""
    return 1.0 / (1.0 + ggx_lambda(alpha, wo) + ggx_lambda(alpha, wi))


def r_evaluate(alpha, specularity, wo, wi):
    """Rough reflection f; 0 when effectively smooth or cross-hemisphere."""
    same_hemi = wo[..., 2] * wi[..., 2] > 0.0
    valid = ~effectively_smooth(alpha) & same_hemi
    halfway = normalize(wo + wi)
    g = height_correlated_g(alpha, wo, wi)
    d = ggx_ndf(alpha, torch.abs(halfway[..., 2]))
    cos_oh = torch.abs(torch.sum(wo * halfway, dim=-1, keepdim=True))
    f = schlick_fresnel(specularity, cos_oh)
    denom = 4.0 * wo[..., 2] * wi[..., 2]
    val = f * (d * g / torch.where(torch.abs(denom) > 1e-10, denom, 1.0))[..., None]
    val = torch.broadcast_to(val, wo.shape)
    return torch.where(valid[..., None], val, 0.0)


def r_pdf(alpha, wo, wi):
    """Bounded-VNDF reflection pdf; 0 when smooth or cross-hemisphere.
    Invalid pairs are swapped for the mirror direction before the pdf math
    so masked lanes never produce inf/NaN."""
    same_hemi = wo[..., 2] * wi[..., 2] > 0.0
    mirror = torch.cat([-wo[..., :2], wo[..., 2:3]], dim=-1)
    wi_safe = torch.where(same_hemi[..., None], wi, mirror)
    p = ggx_bounded_vndf_pdf(alpha, wo, wi_safe)
    return torch.where(effectively_smooth(alpha) | ~same_hemi, 0.0, p)


def r_evaluate_with_pdf(alpha, specularity, wo, wi) -> BSDFResponse:
    return BSDFResponse(r_evaluate(alpha, specularity, wo, wi),
                        r_pdf(alpha, wo, wi))


def r_sample(alpha, specularity, wo, u2) -> BSDFSample:
    """Bounded VNDF for rough lobes, delta mirror when smooth."""
    smooth = effectively_smooth(alpha)
    wi_rough, pdf_rough = ggx_bounded_vndf_sample(alpha, wo, u2)
    f_rough = r_evaluate(alpha, specularity, wo, wi_rough)
    bad = wi_rough[..., 2] < 0.0
    pdf_rough = torch.where(bad, 0.0, pdf_rough)
    f_rough = torch.where(bad[..., None], 0.0, f_rough)
    wi_delta = torch.cat([-wo[..., :2], wo[..., 2:3]], dim=-1)
    abs_z = maximum(torch.abs(wo[..., 2:3]), 1e-7)
    f_delta = schlick_fresnel(specularity, torch.abs(wo[..., 2:3]))
    f_delta = torch.broadcast_to(f_delta / abs_z, wi_delta.shape)

    smooth_b = torch.broadcast_to(smooth, pdf_rough.shape)
    return BSDFSample(
        direction=torch.where(smooth_b[..., None], wi_delta, wi_rough),
        pdf=torch.where(smooth_b, 1.0, pdf_rough),
        is_delta=smooth_b,
        reflectance=torch.where(smooth_b[..., None], f_delta, f_rough))


# -- transmission lobe (GGX_T) -------------------------------------------------

def _like(value, ref):
    """``value`` as a tensor of ``ref``'s dtype and device."""
    return torch.as_tensor(value, dtype=ref.dtype, device=ref.device)


def _mirror_z(ref):
    return _like([1.0, 1.0, -1.0], ref)


def _z_axis(ref):
    return torch.zeros_like(ref) + _like([0.0, 0.0, 1.0], ref)


def _nonzero(x):
    return torch.where(torch.abs(x) > 1e-10, x, 1.0)


def _upper(wo, wi):
    """(wo, wi) mirrored so that wo lies in the upper hemisphere."""
    flip = wo[..., 2:3] < 0.0
    return (torch.where(flip, wo * _mirror_z(wo), wo),
            torch.where(flip, wi * _mirror_z(wo), wi))


def _transmission_pdf_scale(ior_i_over_o, wo, wi, halfway):
    """Change of variables d wh / d wi for refraction (PBRT v3)."""
    wo_h = torch.sum(wo * halfway, dim=-1)
    wi_h = torch.sum(wi * halfway, dim=-1)
    sqrt_denom = wo_h + ior_i_over_o * wi_h
    q = ior_i_over_o / _nonzero(sqrt_denom)
    return q * q * torch.abs(wi_h)


def _transmission_halfway(ior_i_over_o, wo, wi):
    ior = torch.broadcast_to(_like(ior_i_over_o, wo), wo.shape[:-1])[..., None]
    h = normalize(wo + ior * wi)
    return torch.where(h[..., 2:3] < 0.0, -h, h)


def _refract_about(halfway, wo, ior_i_over_o):
    """Refract -wo through microfacet ``halfway`` → (wi, tir mask)."""
    cos_i = torch.sum(wo * halfway, dim=-1, keepdim=True)
    eta = 1.0 / torch.broadcast_to(_like(ior_i_over_o, wo),
                                   wo.shape[:-1])[..., None]
    sin2_t = eta * eta * maximum(1.0 - cos_i * cos_i, 0.0)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(gsafe(1.0 - sin2_t))
    wi = eta * (-wo) + (eta * cos_i - cos_t) * halfway
    return wi, tir[..., 0]


def t_evaluate(alpha, ior_i_over_o, wo, wi, halfway=None):
    """Pure transmission (Fresnel removed, Walter 07 eq. 21)."""
    ior = _like(ior_i_over_o, wo)
    if halfway is None:
        halfway = _transmission_halfway(
            torch.broadcast_to(ior, wo.shape[:-1]), wo, wi)
    cross_hemi = torch.sign(wo[..., 2]) != torch.sign(wi[..., 2])
    wi_h = torch.sum(wi * halfway, dim=-1)
    wo_h = torch.sum(wo * halfway, dim=-1)
    # Backfacing microfacets are discarded (PBRT4 eq. 9.35).
    frontfacing = (wi_h * wi[..., 2] > 0) & (wo_h * wo[..., 2] > 0)
    valid = ~effectively_smooth(alpha) & cross_hemi & frontfacing
    g = height_correlated_g(alpha, wo, wi)
    d = ggx_ndf(alpha, torch.abs(halfway[..., 2]))
    f1 = torch.abs(wo_h * wi_h / _nonzero(wo[..., 2] * wi[..., 2]))
    denom = _nonzero(wo_h + ior * wi_h)
    f2 = ior * ior * g * d / (denom * denom)
    return torch.where(valid, f1 * f2, 0.0)


def t_pdf(alpha, ior_i_over_o, wo, wi):
    ior = _like(ior_i_over_o, wo)
    cross_hemi = torch.sign(wo[..., 2]) != torch.sign(wi[..., 2])
    # Mirrored to the upper hemisphere (the reference flips z when exiting).
    wo_u, wi_u = _upper(wo, wi)
    halfway = _transmission_halfway(torch.broadcast_to(ior, wo.shape[:-1]),
                                    wo_u, wi_u)
    wo_h = torch.sum(wo_u * halfway, dim=-1)
    wi_h = torch.sum(wi_u * halfway, dim=-1)
    valid = (~effectively_smooth(alpha) & cross_hemi
             & (wo_h >= 0.0) & (wi_h < 0.0))
    p = ggx_vndf_pdf(alpha, wo_u, halfway) * _transmission_pdf_scale(
        ior, wo_u, wi_u, halfway)
    return torch.where(valid, p, 0.0)


def t_evaluate_with_pdf(alpha, ior_i_over_o, wo, wi) -> BSDFResponse:
    f = t_evaluate(alpha, ior_i_over_o, wo, wi)
    return BSDFResponse(reflectance=f[..., None].repeat_interleave(3, -1),
                        pdf=t_pdf(alpha, ior_i_over_o, wo, wi))


def t_sample(alpha, ior_i_over_o, wo, u2) -> BSDFSample:
    """Rough or delta transmission; pdf 0 on TIR or energy loss."""
    alpha = _like(alpha, wo)
    ior = _like(ior_i_over_o, wo)
    entering = wo[..., 2:3] >= 0.0
    wo_u = torch.where(entering, wo, wo * _mirror_z(wo))

    # Rough path: VNDF halfway, refract.
    halfway = ggx_vndf_sample_halfway(alpha, wo_u, u2)
    pdf_h = ggx_vndf_pdf(alpha, wo_u, halfway)
    wi_rough, tir = _refract_about(halfway, wo_u, ior)
    bad_rough = tir | (wi_rough[..., 2] >= 0.0)
    pdf_rough = pdf_h * _transmission_pdf_scale(ior, wo_u, wi_rough, halfway)
    f_rough = t_evaluate(alpha, ior, wo_u, wi_rough, halfway)
    pdf_rough = torch.where(bad_rough, 0.0, pdf_rough)
    f_rough = torch.where(bad_rough, 0.0, f_rough)

    # Smooth path: delta refraction through the macro normal.
    wi_delta, tir_delta = _refract_about(_z_axis(wo_u), wo_u, ior)
    abs_z = maximum(torch.abs(wi_delta[..., 2]), 1e-7)
    f_delta = torch.where(tir_delta, 0.0, 1.0 / abs_z)
    pdf_delta = torch.where(tir_delta, 0.0, 1.0)

    smooth = torch.broadcast_to(effectively_smooth(alpha), pdf_rough.shape)
    wi = torch.where(smooth[..., None], wi_delta, wi_rough)
    wi = torch.where(entering, wi, wi * _mirror_z(wo))
    f = torch.where(smooth, f_delta, f_rough)
    return BSDFSample(
        direction=wi,
        pdf=torch.where(smooth, pdf_delta, pdf_rough),
        is_delta=smooth,
        reflectance=f[..., None].repeat_interleave(3, -1))


# -- combined reflection + transmission (rough glass) ---------------------------

def _normalize_reflection_probability(reflection_probability,
                                      transmission_tint):
    """Lobe choice skewed by the transmission tint's brightness
    (GGX.h:268-273)."""
    t_prob = 1.0 - reflection_probability
    scaled_t = torch.sum(transmission_tint, dim=-1) * t_prob
    scaled_r = 3.0 * reflection_probability
    return scaled_r / maximum(scaled_r + scaled_t, 1e-10)


def evaluate(alpha, specularity, ior_i_over_o, wo, wi,
             transmission_tint=None):
    """Combined R+T f (scalar × tint for transmission)."""
    ior = _like(ior_i_over_o, wo)
    wo_u, wi_u = _upper(wo, wi)
    is_reflection = wo_u[..., 2] * wi_u[..., 2] >= 0.0
    halfway_ior = torch.where(is_reflection, 1.0,
                              torch.broadcast_to(ior, is_reflection.shape))
    halfway = _transmission_halfway(halfway_ior, wo_u, wi_u)
    g = height_correlated_g(alpha, wo_u, wi_u)
    d = ggx_ndf(alpha, torch.abs(halfway[..., 2]))
    wo_h = torch.sum(wo_u * halfway, dim=-1)
    wi_h = torch.sum(wi_u * halfway, dim=-1)
    fres = dielectric_schlick_fresnel(specularity, torch.abs(wo_h), ior)

    f_refl = fres * d * g / _nonzero(4.0 * wo_u[..., 2] * wi_u[..., 2])

    frontfacing = (wi_h * wi_u[..., 2] > 0) & (wo_h * wo_u[..., 2] > 0)
    f1 = torch.abs(wo_h * wi_h / _nonzero(wo_u[..., 2] * wi_u[..., 2]))
    q = ior / _nonzero(wo_h + ior * wi_h)
    f2 = (1.0 - fres) * g * d * (q * q)
    f_trans = torch.where(frontfacing, f1 * f2, 0.0)

    valid = (~effectively_smooth(alpha) & (torch.abs(wo[..., 2]) > 0)
             & (torch.abs(wi[..., 2]) > 0))
    f = torch.where(valid, torch.where(is_reflection, f_refl, f_trans), 0.0)
    if transmission_tint is None:
        return f[..., None].repeat_interleave(3, -1)
    tint = torch.where(is_reflection[..., None], 1.0, transmission_tint)
    return f[..., None] * tint


def _ones_tint(wo):
    return torch.ones(wo.shape[:-1] + (3,), dtype=wo.dtype, device=wo.device)


def pdf(alpha, specularity, ior_i_over_o, wo, wi, transmission_tint=None):
    if transmission_tint is None:
        transmission_tint = _ones_tint(wo)
    ior = _like(ior_i_over_o, wo)
    wo_u, wi_u = _upper(wo, wi)
    is_reflection = wo_u[..., 2] * wi_u[..., 2] >= 0.0
    halfway_ior = torch.where(is_reflection, 1.0,
                              torch.broadcast_to(ior, is_reflection.shape))
    halfway = _transmission_halfway(halfway_ior, wo_u, wi_u)
    wo_h = torch.sum(wo_u * halfway, dim=-1)
    wi_h = torch.sum(wi_u * halfway, dim=-1)
    backfacing = ~is_reflection & ((wo_h < 0.0) | (wi_h >= 0.0))

    p = ggx_vndf_pdf(alpha, wo_u, halfway)
    refl_prob = dielectric_schlick_fresnel(specularity, torch.abs(wo_h), ior)
    norm_refl_prob = _normalize_reflection_probability(refl_prob,
                                                       transmission_tint)
    p = p * torch.where(is_reflection, norm_refl_prob, 1.0 - norm_refl_prob)
    scale_r = 1.0 / maximum(4.0 * wo_h, 1e-10)
    scale_t = _transmission_pdf_scale(ior, wo_u, wi_u, halfway)
    p = p * torch.where(is_reflection, scale_r, scale_t)
    valid = ~effectively_smooth(alpha) & ~backfacing
    return torch.where(valid, p, 0.0)


def evaluate_with_pdf(alpha, specularity, ior_i_over_o, wo, wi,
                      transmission_tint=None) -> BSDFResponse:
    return BSDFResponse(
        evaluate(alpha, specularity, ior_i_over_o, wo, wi, transmission_tint),
        pdf(alpha, specularity, ior_i_over_o, wo, wi, transmission_tint))


def sample(alpha, specularity, ior_i_over_o, wo, u3,
           transmission_tint=None) -> BSDFSample:
    """Sample combined R+T: ``u3`` [..., 3], (u, v) for the lobe, w for R
    against T."""
    if transmission_tint is None:
        transmission_tint = _ones_tint(wo)
    alpha = _like(alpha, wo)
    ior = _like(ior_i_over_o, wo)
    entering = wo[..., 2:3] >= 0.0
    mirror = _mirror_z(wo)
    wo_u = torch.where(entering, wo, wo * mirror)
    u2 = u3[..., :2]

    # Rough path.
    halfway = ggx_vndf_sample_halfway(alpha, wo_u, u2)
    pdf_h = ggx_vndf_pdf(alpha, wo_u, halfway)
    wo_h = torch.sum(wo_u * halfway, dim=-1)
    refl_prob = dielectric_schlick_fresnel(specularity, torch.abs(wo_h), ior)
    norm_refl_prob = _normalize_reflection_probability(refl_prob,
                                                       transmission_tint)
    is_refl = u3[..., 2] < norm_refl_prob

    wi_refl = 2.0 * wo_h[..., None] * halfway - wo_u
    pdf_refl = pdf_h * norm_refl_prob / maximum(4.0 * wo_h, 1e-10)
    wi_trans, tir = _refract_about(halfway, wo_u, ior)
    pdf_trans = (pdf_h * (1.0 - norm_refl_prob)
                 * _transmission_pdf_scale(ior, wo_u, wi_trans, halfway))
    pdf_trans = torch.where(tir, 0.0, pdf_trans)

    wi_rough = torch.where(is_refl[..., None], wi_refl, wi_trans)
    pdf_rough = torch.where(is_refl, pdf_refl, pdf_trans)
    energy_loss = torch.where(is_refl, wi_rough[..., 2] < 0.0,
                              wi_rough[..., 2] >= 0.0)
    pdf_rough = torch.where(energy_loss, 0.0, pdf_rough)
    f_rough = evaluate(alpha, specularity, ior, wo_u, wi_rough,
                       transmission_tint)
    f_rough = torch.where(energy_loss[..., None], 0.0, f_rough)

    # Smooth (delta) path.
    refl_prob_d = dielectric_schlick_fresnel(
        specularity, torch.abs(wo_u[..., 2]), ior)
    norm_refl_prob_d = _normalize_reflection_probability(refl_prob_d,
                                                         transmission_tint)
    is_refl_d = u3[..., 2] < norm_refl_prob_d
    wi_mirror = torch.cat([-wo_u[..., :2], wo_u[..., 2:3]], dim=-1)
    wi_refr, tir_d = _refract_about(_z_axis(wo_u), wo_u, ior)
    wi_delta = torch.where(is_refl_d[..., None], wi_mirror, wi_refr)
    pdf_delta = torch.where(is_refl_d, norm_refl_prob_d,
                            1.0 - norm_refl_prob_d)
    pdf_delta = torch.where(~is_refl_d & tir_d, 0.0, pdf_delta)
    abs_z = maximum(torch.abs(wi_delta[..., 2]), 1e-7)
    f_delta_scalar = torch.where(is_refl_d, refl_prob_d,
                                 1.0 - refl_prob_d) / abs_z
    f_delta = f_delta_scalar[..., None] * torch.where(
        is_refl_d[..., None], 1.0, transmission_tint)

    smooth = torch.broadcast_to(effectively_smooth(alpha), pdf_rough.shape)
    wi = torch.where(smooth[..., None], wi_delta, wi_rough)
    wi = torch.where(entering, wi, wi * mirror)
    return BSDFSample(
        direction=wi,
        pdf=torch.where(smooth, pdf_delta, pdf_rough),
        is_delta=smooth,
        reflectance=torch.where(smooth[..., None], f_delta, f_rough))
