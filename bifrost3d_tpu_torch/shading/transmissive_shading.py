"""Transmissive shading model: rough glass through the combined GGX R+T.

Port of ``bifrost3d_tpu/shading/transmissive_shading.py``
(``TransmissiveShading`` with ``create``, ``evaluate_with_pdf``,
``sample``, ``rho``; TransmissiveShading.h:22-97): the IOR derived from
the specularity, the energy loss compensated from the dielectric rho
table, transmission tinted by the material's tint.

Thin-walled variant: a thin sheet never refracts the path. Light reflects
off it or passes straight through, with the throughput of the sheet's
internal bounces (``thin_sheet.approx_thin_sheet_reflectance``). Both
events share the GGX reflection distribution: transmission is that lobe
mirrored below the surface.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bifrost3d_tpu_torch.bsdf import ggx
from bifrost3d_tpu_torch.bsdf.fresnel import dielectric_ior_from_specularity
from bifrost3d_tpu_torch.bsdf.types import BSDFResponse, BSDFSample
from bifrost3d_tpu_torch.math.clip import clip, maximum
from bifrost3d_tpu_torch.shading.fittings import (
    sample_dielectric_ggx_rho,
    sample_ggx_rho,
)
from bifrost3d_tpu_torch.shading.thin_sheet import approx_thin_sheet_reflectance

_MIN_COS = 1e-6


def _flip_z(ref):
    return torch.as_tensor([1.0, 1.0, -1.0], dtype=ref.dtype,
                           device=ref.device)


class TransmissiveShading(NamedTuple):
    transmission_tint: torch.Tensor       # [..., 3]
    specularity: torch.Tensor             # [...]
    ggx_alpha: torch.Tensor               # [...]
    ior_i_over_o: torch.Tensor            # [...]
    energy_loss_adjustment: torch.Tensor  # [...]
    thin_walled: torch.Tensor             # [...] bool
    thin_reflected: torch.Tensor          # [..., 3]
    thin_transmitted: torch.Tensor        # [..., 3]
    thin_rho_norm: torch.Tensor           # [...] 1 / GGX rho

    @staticmethod
    def create(tint, roughness, specularity, cos_theta_o,
               thin_walled=None) -> "TransmissiveShading":
        """``cos_theta_o`` is signed: negative is seen from inside.

        The specularity is clipped to the dielectric range [1e-4, 0.25]
        before the IOR conversion: every lane evaluates every model, and a
        metal lane's specularity 1 (IOR ∞) would leave a masked NaN that
        still poisons a backward pass."""
        medium_ior = dielectric_ior_from_specularity(
            clip(specularity, 1e-4, 0.25))
        entering = cos_theta_o >= 0.0
        ior_i_over_o = torch.where(entering, medium_ior, 1.0 / medium_ior)
        abs_cos = torch.abs(cos_theta_o)
        total_rho, _ = sample_dielectric_ggx_rho(abs_cos, roughness,
                                                 ior_i_over_o)
        # Thin sheets are symmetric, seen from the viewer's side.
        tint3 = torch.broadcast_to(
            torch.as_tensor(tint, dtype=abs_cos.dtype, device=abs_cos.device),
            torch.broadcast_shapes(torch.Size(torch.as_tensor(tint).shape),
                                   medium_ior.shape + (3,)))
        sheet = approx_thin_sheet_reflectance(abs_cos, roughness, medium_ior,
                                              tint3)
        lobe_rho = sample_ggx_rho(abs_cos, roughness)
        if thin_walled is None:
            thin_walled = torch.zeros(medium_ior.shape, dtype=torch.bool,
                                      device=medium_ior.device)
        shape = ior_i_over_o.shape
        return TransmissiveShading(
            transmission_tint=tint3,
            specularity=torch.broadcast_to(specularity, shape),
            ggx_alpha=torch.broadcast_to(ggx.alpha_from_roughness(roughness),
                                         shape),
            ior_i_over_o=ior_i_over_o,
            energy_loss_adjustment=1.0 / maximum(total_rho, 1e-5),
            thin_walled=torch.broadcast_to(thin_walled, shape),
            thin_reflected=sheet.reflected,
            thin_transmitted=sheet.transmitted,
            thin_rho_norm=1.0 / maximum(lobe_rho, 1e-5))

    def _thin_reflect_probability(self):
        r = torch.mean(self.thin_reflected, dim=-1)
        t = torch.mean(self.thin_transmitted, dim=-1)
        return r / maximum(r + t, 1e-9)

    def evaluate_with_pdf(self, wo, wi) -> BSDFResponse:
        frontside = wo[..., 2] > _MIN_COS
        r = ggx.evaluate_with_pdf(
            self.ggx_alpha, self.specularity, self.ior_i_over_o, wo, wi,
            transmission_tint=self.transmission_tint)
        thick_f = r.reflectance * self.energy_loss_adjustment[..., None]
        thick_pdf = r.pdf

        # Thin sheet: the reflection lobe above, the same lobe mirrored
        # below.
        up = wi[..., 2] >= 0.0
        wi_ref = torch.where(up[..., None], wi, wi * _flip_z(wi))
        lobe_f = ggx.r_evaluate(self.ggx_alpha, 1.0, wo, wi_ref)
        lobe_pdf = ggx.r_pdf(self.ggx_alpha, wo, wi_ref)
        weight = torch.where(up[..., None], self.thin_reflected,
                             self.thin_transmitted)
        thin_f = weight * lobe_f * self.thin_rho_norm[..., None]
        p_refl = self._thin_reflect_probability()
        thin_pdf = torch.where(up, p_refl, 1.0 - p_refl) * lobe_pdf

        tw = self.thin_walled
        f = torch.where(tw[..., None], thin_f, thick_f)
        pdf = torch.where(tw, thin_pdf, thick_pdf)
        return BSDFResponse(
            reflectance=torch.where(frontside[..., None], f, 0.0),
            pdf=torch.where(frontside, pdf, 0.0))

    def sample(self, wo, u3) -> BSDFSample:
        s = ggx.sample(self.ggx_alpha, self.specularity, self.ior_i_over_o,
                       wo, u3, transmission_tint=self.transmission_tint)
        thick_f = s.reflectance * self.energy_loss_adjustment[..., None]

        # Thin sheet: the reflection lobe's sample, mirrored below the
        # surface with probability 1 - p_refl.
        sr = ggx.r_sample(self.ggx_alpha, 1.0, wo, u3[..., :2])
        p_refl = self._thin_reflect_probability()
        transmit = u3[..., 2] >= p_refl
        thin_dir = torch.where(transmit[..., None],
                               sr.direction * _flip_z(wo), sr.direction)
        weight = torch.where(transmit[..., None], self.thin_transmitted,
                             self.thin_reflected)
        thin_f = weight * sr.reflectance * self.thin_rho_norm[..., None]
        thin_pdf = sr.pdf * torch.where(transmit, 1.0 - p_refl, p_refl)

        tw = self.thin_walled
        frontside = wo[..., 2] > _MIN_COS
        return BSDFSample(
            direction=torch.where(tw[..., None], thin_dir, s.direction),
            pdf=torch.where(frontside, torch.where(tw, thin_pdf, s.pdf), 0.0),
            is_delta=torch.where(tw, sr.is_delta, s.is_delta) & frontside,
            reflectance=torch.where(
                frontside[..., None],
                torch.where(tw[..., None], thin_f, thick_f), 0.0))

    def rho(self, abs_cos_theta_o):
        roughness = ggx.roughness_from_alpha(self.ggx_alpha)
        total, reflected = sample_dielectric_ggx_rho(
            abs_cos_theta_o, roughness, self.ior_i_over_o)
        reflection = reflected / maximum(total, 1e-9)
        thick = (reflection[..., None]
                 + (1.0 - reflection)[..., None] * self.transmission_tint)
        thin = self.thin_reflected + self.thin_transmitted
        return torch.where(self.thin_walled[..., None], thin, thick)
