"""Faults planted under the timed path, to show that the output check
catches them: a test drives a whole run with one in place, and
``calibrate.py --fault`` reads the check's numbers with one at a cell's
own size. Each entry is (module of ``bifrost3d_tpu_torch``, attribute,
wrapper of the real attribute)."""

from __future__ import annotations

import importlib

import torch


def _scaled_frames(real):
    def frame(*args, **kw):
        img, rays = real(*args, **kw)
        return img * 1.01, rays
    return frame


def _half_frames(real):
    def frame(*args, **kw):
        img, rays = real(*args, **kw)
        img = img.clone()
        img[img.shape[0] // 2:] = 0.0
        return img, rays
    return frame


def _unchanged_buffer(real):
    def progressive(scene, camera, width, height, accumulations, *a, **kw):
        return torch.zeros((height, width, 3), device=scene.tri_verts.device)
    return progressive


def _altered_post(real):
    def process(image, *a, **kw):
        ldr = real(image, *a, **kw).clone()
        ldr[0, 0] = (ldr[0, 0] + 2.0 / 255.0) % 1.0
        return ldr
    return process


def _fit_state_unchanged(real):
    def optimize(scene, *a, **kw):
        return real(scene, *a, **kw)._replace(scene=scene)
    return optimize


def _half_loss(real):
    def loss(image, target):
        half = image.shape[0] // 2
        return real(image[:half], target[:half])
    return loss


def _scaled_image(real):
    def render(*a, **kw):
        return real(*a, **kw) * 1.01
    return render


FAULTS = {
    "progressive_render": {
        "frame_altered": ("integrator.pallas_mesh", "render_mesh_megakernel",
                          _scaled_frames),
        "half_of_the_pixels_left_out": ("integrator.pallas_mesh",
                                        "render_mesh_megakernel",
                                        _half_frames),
        "state_returned_unchanged": ("integrator.path_tracer",
                                     "render_progressive", _unchanged_buffer),
        "post_output_altered": ("post.pipeline", "process", _altered_post),
    },
    "material_fit": {
        "state_returned_unchanged": ("diff.render_grad",
                                     "optimize_materials",
                                     _fit_state_unchanged),
        "half_of_the_pixels_left_out": ("diff.render_grad", "image_l2_loss",
                                        _half_loss),
        "image_altered": ("diff.render_grad", "render_sample",
                          _scaled_image),
    },
}


def plant(job: str, name: str, setattr_fn=setattr):
    """Put fault ``name`` of the traffic job ``job`` in place (``setattr_fn`` lets a
    test's monkeypatch undo it)."""
    module_name, attr, wrap = FAULTS[job][name]
    module = importlib.import_module("bifrost3d_tpu_torch." + module_name)
    setattr_fn(module, attr, wrap(getattr(module, attr)))
