"""Diffuse shading model: tint + roughness → EON Oren-Nayar only.

Port of ``bifrost3d_tpu/shading/diffuse_shading.py`` (``DiffuseShading``
with ``create``, ``evaluate_with_pdf``, ``sample``, ``rho``), the counterpart of
``Shading/ShadingModels/DiffuseShading.h:21-50``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bifrost3d_tpu_torch.bsdf import oren_nayar
from bifrost3d_tpu_torch.bsdf.types import BSDFResponse, BSDFSample

_MIN_COS = 1e-6


class DiffuseShading(NamedTuple):
    tint: torch.Tensor       # [..., 3]
    roughness: torch.Tensor  # [...]

    @staticmethod
    def create(tint, roughness) -> "DiffuseShading":
        return DiffuseShading(tint=tint, roughness=roughness)

    def evaluate_with_pdf(self, wo, wi) -> BSDFResponse:
        frontside = (wo[..., 2] > _MIN_COS) & (wi[..., 2] > _MIN_COS)
        r = oren_nayar.evaluate_with_pdf(self.tint, self.roughness, wo, wi)
        return BSDFResponse(
            reflectance=torch.where(frontside[..., None], r.reflectance, 0.0),
            pdf=torch.where(frontside, r.pdf, 0.0))

    def sample(self, wo, u3) -> BSDFSample:
        s = oren_nayar.sample(self.tint, self.roughness, wo, u3[..., :2])
        frontside = wo[..., 2] > _MIN_COS
        return BSDFSample(
            direction=s.direction,
            pdf=torch.where(frontside, s.pdf, 0.0),
            is_delta=s.is_delta,
            reflectance=torch.where(frontside[..., None], s.reflectance, 0.0))

    def rho(self, abs_cos_theta):
        return self.tint
