"""Render backends: plain progressive and denoised presentation.

Port of ``bifrost3d_tpu/integrator/backend.py`` (``SimpleBackend``,
``_atrous_pass``, ``atrous_denoise``, ``DenoisedBackend``), the
counterpart of the reference's ``IBackend`` (IBackend.h:23-66):
``SimpleBackend`` renders one progressive frame per call through
``render_sample_fast`` (on a card the mesh megakernel where the scene is
eligible, else the pooled wavefront) into a running mean;
``DenoisedBackend`` filters that mean with an edge-avoiding à-trous
wavelet filter guided by the shading-normal and albedo AOVs (one
primary-ray trace, ``integrator/aov.render_aovs``), on power-of-two frames
or every 32nd, the reference's presentation cadence. The filter is eager
PyTorch: 25 taps of a few elementwise kernels each, four times.
"""

from __future__ import annotations

import numpy as np
import torch

from bifrost3d_tpu_torch.integrator.aov import render_aovs
from bifrost3d_tpu_torch.integrator.path_tracer import (
    RenderSettings,
    render_sample_fast,
)
from bifrost3d_tpu_torch.math.clip import maximum

_B3_TAPS = (-2, -1, 0, 1, 2)
_B3_KERNEL = np.asarray([1 / 16, 1 / 4, 3 / 8, 1 / 4, 1 / 16], np.float32)


class SimpleBackend:
    """One progressive frame per :meth:`render` and its running mean."""

    def __init__(self, scene, camera, width: int, height: int,
                 settings: RenderSettings = RenderSettings(),
                 pool_size: int = 65536):
        self.scene = scene
        self.camera = camera
        self.width = width
        self.height = height
        self.settings = settings
        self.pool_size = pool_size
        self.accumulations = 0
        self.buffer = self._zeros()

    def _zeros(self):
        return torch.zeros((self.height, self.width, 3), dtype=torch.float32,
                           device=self.scene.tri_verts.device)

    def reset(self) -> None:
        self.accumulations = 0
        self.buffer = self._zeros()

    def render(self):
        frame = render_sample_fast(
            self.scene, self.camera, self.width, self.height,
            self.accumulations, self.settings, self.pool_size)
        self.accumulations += 1
        self.buffer = self.buffer + (frame - self.buffer) / self.accumulations
        return self.buffer


def _atrous_pass(color, normal, albedo, step: int, sigma_color=4.0,
                 sigma_normal=128.0, sigma_albedo=8.0):
    """One edge-avoiding à-trous iteration with 5-tap B3-spline weights;
    taps wrap around the image edges, as ``jnp.roll``'s do."""
    acc = torch.zeros_like(color)
    weight_sum = torch.zeros(color.shape[:2] + (1,), dtype=color.dtype,
                             device=color.device)
    for iy, ty in enumerate(_B3_TAPS):
        for ix, tx in enumerate(_B3_TAPS):
            k = float(_B3_KERNEL[iy] * _B3_KERNEL[ix])
            shift = (-ty * step, -tx * step)
            c = torch.roll(color, shift, dims=(0, 1))
            n = torch.roll(normal, shift, dims=(0, 1))
            a = torch.roll(albedo, shift, dims=(0, 1))
            w_c = torch.exp(-torch.sum(torch.square(c - color), -1,
                                       keepdim=True) * sigma_color)
            w_n = torch.exp(-maximum(
                1.0 - torch.sum(n * normal, -1, keepdim=True), 0.0)
                * sigma_normal)
            w_a = torch.exp(-torch.sum(torch.square(a - albedo), -1,
                                       keepdim=True) * sigma_albedo)
            wgt = k * w_c * w_n * w_a
            acc = acc + c * wgt
            weight_sum = weight_sum + wgt
    return acc / maximum(weight_sum, 1e-8)


def atrous_denoise(color, normal, albedo, iterations: int = 4):
    """Edge-avoiding à-trous wavelet denoise (Dammertz et al. 2010):
    ``iterations`` passes at tap spacings 1, 2, 4, ..."""
    out = color
    for i in range(iterations):
        out = _atrous_pass(out, normal, albedo, step=1 << i)
    return out


class DenoisedBackend(SimpleBackend):
    """SimpleBackend + guided denoise with the logarithmic presentation
    cadence (IBackend.cpp:19-80: denoise on power-of-two frames or every
    32nd); other frames return the last denoised image."""

    def __init__(self, *args, denoise_iterations: int = 4, **kwargs):
        super().__init__(*args, **kwargs)
        self.denoise_iterations = denoise_iterations
        self._aovs = None
        self._denoised = None

    def _should_denoise(self) -> bool:
        n = self.accumulations
        is_pow2 = (n & (n - 1)) == 0
        # JAX's expression as written: (n > 0 and (...)) or no image yet.
        return n > 0 and (is_pow2 or n % 32 == 0) or self._denoised is None

    def render(self):
        super().render()
        if self._aovs is None:
            self._aovs = render_aovs(self.scene, self.camera, self.width,
                                     self.height)
        if self._should_denoise():
            self._denoised = atrous_denoise(
                self.buffer, self._aovs["shading_normal"],
                self._aovs["albedo"], self.denoise_iterations)
        return self._denoised

    def reset(self) -> None:
        super().reset()
        self._aovs = None
        self._denoised = None
