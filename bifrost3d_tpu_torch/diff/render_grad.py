"""Gradients of rendered images with respect to scene parameters, and
inverse rendering.

Port of ``bifrost3d_tpu/diff/render_grad.py``. The forward wavefront
(``integrator/path_tracer.py``) detaches its hit queries, so autograd
flows from pixel radiance back to the material fields, light powers and
positions, the environment and the vertex buffers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bifrost3d_tpu_torch.integrator.path_tracer import (
    RenderSettings,
    render_sample,
)
from bifrost3d_tpu_torch.scene.render_scene import RenderScene
from bifrost3d_tpu_torch.utils.tree import tree_flatten


def image_l2_loss(image, target):
    return torch.mean(torch.square(image - target))


def _render_mean(scene, camera, width, height, accumulation, settings, spp):
    img = 0.0
    for s in range(spp):
        img = img + render_sample(scene, camera, width, height,
                                  accumulation + s, settings)
    return img / spp


def render_loss_grad(scene: RenderScene, camera, target, width: int,
                     height: int, accumulation: int,
                     settings: RenderSettings = RenderSettings(),
                     spp: int = 1):
    """→ (loss, grads): ``grads`` is a RenderScene of the same structure
    whose every float tensor holds its gradient (zeros where the loss does
    not depend on it, as for the trace tables, which the queries detach)
    and whose every integer tensor is None."""
    leaves, unflatten = tree_flatten(scene)
    params = [t.detach().requires_grad_() if t.is_floating_point() else t
              for t in leaves]
    loss = image_l2_loss(
        _render_mean(unflatten(params), camera, width, height,
                     int(accumulation), settings, spp), target)
    floats = [p for p in params if p.requires_grad]
    grads = iter(torch.autograd.grad(loss, floats, allow_unused=True))
    cotangents = []
    for p in params:
        if not p.requires_grad:
            cotangents.append(None)
            continue
        g = next(grads)
        cotangents.append(torch.zeros_like(p) if g is None else g)
    return loss.detach(), unflatten(cotangents)


class OptimizeResult(NamedTuple):
    scene: RenderScene
    losses: list


def optimize_materials(scene: RenderScene, camera, target, width: int,
                       height: int, steps: int = 32,
                       learning_rate: float = 5e-2, spp: int = 1,
                       vary_samples: bool = True,
                       settings: RenderSettings = RenderSettings()
                       ) -> OptimizeResult:
    """Adam over the material tints and roughnesses to match a target
    image; geometry and lights stay fixed, and after each step the tints
    are clamped to [0, 1] and the roughnesses to [0.02, 1].

    ``torch.optim.Adam`` makes the update of the JAX version's
    ``optax.adam``: b1 0.9, b2 0.999, eps 1e-8 added outside the square
    root of the bias-corrected second moment.

    ``vary_samples=False`` renders the same sample sequence every step
    (deterministic descent towards a same-seed target, no Monte Carlo noise
    floor in the loss); True takes fresh samples each step (stochastic
    descent over the expected loss). ``losses`` are each step's loss
    before its update.
    """
    tint = scene.materials.tint.detach().clone().requires_grad_()
    roughness = scene.materials.roughness.detach().clone().requires_grad_()
    opt = torch.optim.Adam([tint, roughness], lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for step in range(steps):
        accumulation = step * spp if vary_samples else 0
        mats = scene.materials._replace(tint=tint, roughness=roughness)
        loss = image_l2_loss(
            _render_mean(scene._replace(materials=mats), camera, width,
                         height, accumulation, settings, spp), target)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        with torch.no_grad():
            tint.clamp_(0.0, 1.0)
            roughness.clamp_(0.02, 1.0)
        losses.append(float(loss.detach()))
    mats = scene.materials._replace(tint=tint.detach(),
                                    roughness=roughness.detach())
    return OptimizeResult(scene=scene._replace(materials=mats), losses=losses)
