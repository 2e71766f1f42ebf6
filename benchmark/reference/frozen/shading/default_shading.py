"""The Default shading model: EON diffuse + GGX specular + optional coat.

Port of ``bifrost3d_tpu/shading/default_shading.py``
(``modulate_roughness_under_coat``, ``_specular_properties``,
``DefaultShading.create``, ``create_with_max_pdf_hint``,
``evaluate_with_pdf``, ``sample``, ``rho``). Per shading
point, construction bakes the coat-modulated roughness, the specularities
re-based under the coat medium, the metallic blend, the rho-table energy
compensation and the per-lobe sampling probabilities.

Scalar parameters are per lane ``[...]``; ``tint`` is ``[..., 3]``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.frozen.bsdf import ggx, oren_nayar
from benchmark.reference.frozen.bsdf.fresnel import (
    COAT_IOR,
    COAT_SPECULARITY,
    adjust_conductor_specularity_to_exterior_medium,
    adjust_dielectric_specularity_to_exterior_medium,
)
from benchmark.reference.frozen.bsdf.types import BSDFResponse, BSDFSample
from benchmark.reference.frozen.math.clip import clip, maximum, minimum
from benchmark.reference.frozen.math.vec import lerp
from benchmark.reference.frozen.shading.fittings import (
    estimate_ggx_alpha_from_max_pdf,
    sample_ggx_rho,
    sample_ggx_with_fresnel_rho,
)

_MIN_COS = 1e-6


def modulate_roughness_under_coat(base_roughness, coat_roughness):
    """OpenPBR 2025 eq. 86 (Utils.h:363-367)."""
    x_coat = 1.0 - 1.0 / COAT_IOR
    r4 = minimum(
        base_roughness ** 4 + 2.0 * x_coat * coat_roughness ** 4, 1.0)
    return r4 ** 0.25


def _specular_properties(roughness, specularity, scale, abs_cos_theta_o):
    """(alpha, reflection_scale, transmission_scale, base_rho, full_rho) per
    lane; reflection_scale folds the multi-scatter compensation 1/full_rho.
    ``specularity`` is per lane or a float."""
    alpha = ggx.alpha_from_roughness(roughness)
    base = sample_ggx_with_fresnel_rho(abs_cos_theta_o, roughness)
    full = sample_ggx_rho(abs_cos_theta_o, roughness)
    reflection_scale = scale / maximum(full, 1e-5)
    rho = lerp(base, full, specularity) * reflection_scale
    return alpha, reflection_scale, 1.0 - rho, base, full


class DefaultShading(NamedTuple):
    diffuse_tint: torch.Tensor          # [..., 3]
    roughness: torch.Tensor             # [...]
    specularity: torch.Tensor           # [..., 3]
    specular_scale: torch.Tensor        # [...]
    coat_scale: torch.Tensor            # [...]
    coat_alpha: torch.Tensor            # [...]
    specular_probability: torch.Tensor  # [...]
    coat_probability: torch.Tensor      # [...]

    @staticmethod
    def create(tint, roughness, specularity, metallic, coat, coat_roughness,
               abs_cos_theta_o, min_roughness=None) -> "DefaultShading":
        """Vectorized constructor (DefaultShading.h:66-178).
        ``min_roughness`` (per lane) is the path-regularization floor of
        both roughnesses (:meth:`create_with_max_pdf_hint`); at a tie the
        gradient splits between the two, as ``jnp.maximum``'s does."""
        if min_roughness is not None:
            roughness = torch.maximum(roughness, min_roughness)
            coat_roughness = torch.maximum(coat_roughness, min_roughness)
        conductor_specularity = tint
        has_coat = coat > 0.0
        has_coat_c = has_coat[..., None]
        coat_c = coat[..., None]

        coat_mod = modulate_roughness_under_coat(roughness, coat_roughness)
        m_roughness = torch.where(has_coat, lerp(roughness, coat_mod, coat),
                                  roughness)
        coated_diel = adjust_dielectric_specularity_to_exterior_medium(
            COAT_IOR, minimum(specularity, 0.9999))
        dielectric_specularity = torch.where(
            has_coat & (specularity < 1.0),
            lerp(specularity, coated_diel, coat), specularity)
        coated_cond = adjust_conductor_specularity_to_exterior_medium(
            COAT_IOR, clip(conductor_specularity, 0.0, 0.9999),
            torch.zeros_like(conductor_specularity))
        coated_cond = torch.where(torch.isnan(coated_cond), 1.0, coated_cond)
        conductor_specularity = torch.where(
            has_coat_c, lerp(conductor_specularity, coated_cond, coat_c),
            conductor_specularity)

        # Dielectric layer: energy-compensated specular + transmitted diffuse.
        _, specular_scale, diel_transmission, base, full = \
            _specular_properties(m_roughness, dielectric_specularity, 1.0,
                                 abs_cos_theta_o)
        dielectric_tint = tint * diel_transmission[..., None]
        metallic_c = metallic[..., None]
        m_specularity = lerp(
            torch.broadcast_to(dielectric_specularity[..., None], tint.shape),
            conductor_specularity, metallic_c)
        m_diffuse_tint = dielectric_tint * (1.0 - metallic_c)

        # Coat layer: GGX with fixed IOR 1.5 / specularity 0.04; the coat
        # strength is folded into its reflection scale.
        coat_alpha_full, coat_refl_scale, coat_transmission, c_base, c_full = \
            _specular_properties(coat_roughness, COAT_SPECULARITY, coat,
                                 abs_cos_theta_o)
        coat_rho = (lerp(c_base, c_full, COAT_SPECULARITY) * coat_refl_scale)
        m_coat_scale = torch.where(has_coat, coat_refl_scale, 0.0)
        m_coat_alpha = torch.where(has_coat, coat_alpha_full, 0.0)
        coat_rho = torch.where(has_coat, coat_rho, 0.0)
        specular_scale = torch.where(
            has_coat, specular_scale * coat_transmission, specular_scale)
        m_diffuse_tint = torch.where(
            has_coat_c, m_diffuse_tint * coat_transmission[..., None],
            m_diffuse_tint)

        # Sampling probabilities ∝ per-lobe rho sums.
        diffuse_rho_sum = torch.sum(m_diffuse_tint, dim=-1)
        spec_rho = (lerp(base[..., None], full[..., None], m_specularity)
                    * specular_scale[..., None])
        specular_rho_sum = torch.sum(spec_rho, dim=-1)
        coat_rho_sum = 3.0 * coat_rho
        recip = 1.0 / maximum(
            diffuse_rho_sum + specular_rho_sum + coat_rho_sum, 1e-9)
        return DefaultShading(
            diffuse_tint=m_diffuse_tint,
            roughness=m_roughness,
            specularity=m_specularity,
            specular_scale=specular_scale,
            coat_scale=m_coat_scale,
            coat_alpha=m_coat_alpha,
            specular_probability=specular_rho_sum * recip,
            coat_probability=coat_rho_sum * recip)

    @staticmethod
    def create_with_max_pdf_hint(tint, roughness, specularity, metallic, coat,
                                 coat_roughness, abs_cos_theta_o, max_pdf,
                                 pdf_is_delta=None) -> "DefaultShading":
        """Path regularization (DefaultShading.h:175-178): clamp roughness
        from below using the previous bounce's max BSDF PDF."""
        min_alpha = estimate_ggx_alpha_from_max_pdf(abs_cos_theta_o, max_pdf)
        min_roughness = ggx.roughness_from_alpha(min_alpha)
        if pdf_is_delta is not None:
            min_roughness = torch.where(pdf_is_delta, 0.0, min_roughness)
        return DefaultShading.create(
            tint, roughness, specularity, metallic, coat, coat_roughness,
            abs_cos_theta_o, min_roughness=min_roughness)

    @property
    def diffuse_probability(self):
        return 1.0 - self.specular_probability - self.coat_probability

    @property
    def specular_alpha(self):
        return ggx.alpha_from_roughness(self.roughness)

    def evaluate_with_pdf(self, wo, wi) -> BSDFResponse:
        """Sum of lobes + probability-weighted pdf (DefaultShading.h:191-215)."""
        frontside = (wo[..., 2] > _MIN_COS) & (wi[..., 2] > _MIN_COS)
        d = oren_nayar.evaluate_with_pdf(self.diffuse_tint, self.roughness,
                                         wo, wi)
        s = ggx.r_evaluate_with_pdf(self.specular_alpha, self.specularity,
                                    wo, wi)
        c = ggx.r_evaluate_with_pdf(self.coat_alpha, COAT_SPECULARITY, wo, wi)
        reflectance = (d.reflectance
                       + s.reflectance * self.specular_scale[..., None]
                       + c.reflectance * self.coat_scale[..., None])
        pdf = (d.pdf * self.diffuse_probability
               + s.pdf * self.specular_probability
               + c.pdf * self.coat_probability)
        return BSDFResponse(
            reflectance=torch.where(frontside[..., None], reflectance, 0.0),
            pdf=torch.where(frontside, pdf, 0.0))

    def sample(self, wo, u3) -> BSDFSample:
        """Pick a lobe ∝ rho, sample it, add the other lobes' f and pdf
        (DefaultShading.h:218-280), branch-free."""
        pick = u3[..., 2]
        sample_coat = pick < self.coat_probability
        sample_specular = (~sample_coat
                           & (pick < self.coat_probability
                              + self.specular_probability))

        u2 = u3[..., :2]
        s_dif = oren_nayar.sample(self.diffuse_tint, self.roughness, wo, u2)
        s_spec = ggx.r_sample(self.specular_alpha, self.specularity, wo, u2)
        s_coat = ggx.r_sample(self.coat_alpha, COAT_SPECULARITY, wo, u2)

        direction = torch.where(
            sample_coat[..., None], s_coat.direction,
            torch.where(sample_specular[..., None], s_spec.direction,
                        s_dif.direction))

        resp = self.evaluate_with_pdf(wo, direction)
        frontside = wo[..., 2] > _MIN_COS
        pdf = torch.where(frontside, resp.pdf, 0.0)
        reflectance = resp.reflectance

        # Smooth specular/coat lobes are delta mirrors: keep the lobe's own
        # delta sample.
        delta_spec = sample_specular & s_spec.is_delta
        delta_coat = sample_coat & s_coat.is_delta
        is_delta = delta_spec | delta_coat
        delta_f = torch.where(
            delta_spec[..., None],
            s_spec.reflectance * self.specular_scale[..., None],
            s_coat.reflectance * self.coat_scale[..., None])
        delta_pdf = torch.where(delta_spec, self.specular_probability,
                                self.coat_probability)
        pdf = torch.where(is_delta, delta_pdf, pdf)
        reflectance = torch.where(is_delta[..., None], delta_f, reflectance)
        return BSDFSample(direction=direction, pdf=pdf,
                          is_delta=is_delta & frontside,
                          reflectance=reflectance)

    # -- rho ------------------------------------------------------------------

    def rho(self, abs_cos_theta):
        """Directional-hemispherical reflectance (the albedo AOV)."""
        return (self.diffuse_rho(abs_cos_theta)
                + self.specular_rho(abs_cos_theta)
                + self.coat_rho(abs_cos_theta)[..., None])

    def diffuse_rho(self, abs_cos_theta):
        return self.diffuse_tint

    def specular_rho(self, abs_cos_theta):
        base = sample_ggx_with_fresnel_rho(abs_cos_theta, self.roughness)
        full = sample_ggx_rho(abs_cos_theta, self.roughness)
        return (lerp(base[..., None], full[..., None], self.specularity)
                * self.specular_scale[..., None])

    def coat_rho(self, abs_cos_theta):
        coat_roughness = ggx.roughness_from_alpha(maximum(self.coat_alpha, 0.0))
        base = sample_ggx_with_fresnel_rho(abs_cos_theta, coat_roughness)
        full = sample_ggx_rho(abs_cos_theta, coat_roughness)
        return lerp(base, full, COAT_SPECULARITY) * self.coat_scale
