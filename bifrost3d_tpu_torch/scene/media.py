"""Participating-media parameter conversions.

Port of ``bifrost3d_tpu/scene/media.py`` (``Assets/Media.h``): measured ↔
artistic scattering parameters (Chiang et al. 2016 mapping), derived
quantities (attenuation, mean free path, single-scattering and diffuse
albedo) and the Jensen 2001 measured presets, on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class MeasuredScatteringParameters(NamedTuple):
    scattering_coefficient: torch.Tensor  # [..., 3] sigma_s
    absorption_coefficient: torch.Tensor  # [..., 3] sigma_a

    @property
    def attenuation_coefficient(self):
        return self.scattering_coefficient + self.absorption_coefficient

    @property
    def mean_free_path(self):
        return 1.0 / self.attenuation_coefficient

    @property
    def single_scattering_albedo(self):
        return self.scattering_coefficient / self.attenuation_coefficient

    def diffuse_albedo(self, medium_ior: float = 1.3):
        """Jensen et al. 2001 diffusion-theory reflectance (Media.h:42-60)."""
        alpha = self.single_scattering_albedo
        fdr = (-1.44 / (medium_ior * medium_ior) + 0.71 / medium_ior
               + 0.668 + 0.0636 * medium_ior)
        a = (1.0 + fdr) / (1.0 - fdr)
        e2 = -torch.sqrt(3.0 * (1.0 - alpha))
        e1 = 4.0 / 3.0 * a * e2
        return 0.5 * alpha * (1.0 + torch.exp(e1)) * torch.exp(e2)

    @staticmethod
    def from_artistic(artistic: "ArtisticScatteringParameters"):
        """Chiang et al. 2016 inversion (Media.h:111-123)."""
        a = torch.as_tensor(artistic.diffuse_albedo, dtype=torch.float32)
        exponent = -5.09406 * a + 2.61188 * a * a - 4.31805 * a * a * a
        ss_albedo = 1.0 - torch.exp(exponent)
        attenuation = 1.0 / torch.as_tensor(artistic.mean_free_path, dtype=torch.float32)
        sigma_s = ss_albedo * attenuation
        return MeasuredScatteringParameters(
            scattering_coefficient=sigma_s,
            absorption_coefficient=attenuation - sigma_s)


class ArtisticScatteringParameters(NamedTuple):
    diffuse_albedo: torch.Tensor   # [..., 3]
    mean_free_path: torch.Tensor   # [..., 3]

    @staticmethod
    def from_measured(measured: MeasuredScatteringParameters,
                      medium_ior: float = 1.3):
        return ArtisticScatteringParameters(
            diffuse_albedo=measured.diffuse_albedo(medium_ior),
            mean_free_path=measured.mean_free_path)


def _measured(s, a):
    return MeasuredScatteringParameters(
        scattering_coefficient=torch.tensor(s, dtype=torch.float32),
        absorption_coefficient=torch.tensor(a, dtype=torch.float32))


# Jensen et al. 2001 measured presets (Media.h:63-75).
MEASURED_PRESETS = {
    "apple": _measured((2.29, 2.39, 1.97), (0.003, 0.0034, 0.046)),
    "chicken1": _measured((0.15, 0.21, 0.38), (0.015, 0.077, 0.19)),
    "chicken2": _measured((0.19, 0.25, 0.32), (0.018, 0.088, 0.2)),
    "cream": _measured((7.38, 5.47, 3.15), (0.0002, 0.0028, 0.0163)),
    "ketchup": _measured((0.18, 0.07, 0.03), (0.061, 0.97, 1.45)),
    "marble": _measured((2.19, 2.62, 3.00), (0.0021, 0.0041, 0.0071)),
    "potato": _measured((0.68, 0.70, 0.55), (0.0024, 0.0090, 0.12)),
    "skimmilk": _measured((0.70, 1.22, 1.90), (0.0014, 0.0025, 0.0142)),
    "skin1": _measured((0.74, 0.88, 1.01), (0.032, 0.17, 0.48)),
    "skin2": _measured((1.09, 1.59, 1.79), (0.013, 0.070, 0.145)),
    "wholemilk": _measured((2.55, 3.21, 3.77), (0.0011, 0.0024, 0.014)),
}
