"""Faults of the ``progressive_render`` job: a frame altered where the
megakernel produces it, half of its pixels left out, the running mean
returned unchanged, and the post's output altered."""

from __future__ import annotations

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


FAULTS = {
    "frame_altered": ("integrator.pallas_mesh", "render_mesh_megakernel",
                      _scaled_frames),
    "half_of_the_pixels_left_out": ("integrator.pallas_mesh",
                                    "render_mesh_megakernel", _half_frames),
    "state_returned_unchanged": ("integrator.path_tracer",
                                 "render_progressive", _unchanged_buffer),
    "post_output_altered": ("post.pipeline", "process", _altered_post),
}
