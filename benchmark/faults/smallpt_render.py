"""Faults of the ``smallpt_render`` job: each frame scaled where the SmallPT
megakernel lerps it into the running mean, half of its rows left out, and
the app's running mean returned as it started."""

from __future__ import annotations

import torch


def _scaled_frames(real):
    """Frame n scaled by 1.01 before the lerp, so the running mean comes
    out 1.01 times the true one."""
    def accumulate(scene, width, height, n, buffer):
        before = buffer.clone()
        real(scene, width, height, n, buffer)
        frame = before + (buffer - before) * n
        buffer.add_(frame * (0.01 / n))
        return buffer
    return accumulate


def _half_rows(real):
    """The upper half of frame n's rows black before the lerp."""
    def accumulate(scene, width, height, n, buffer):
        upper = buffer[height // 2:].clone()
        real(scene, width, height, n, buffer)
        buffer[height // 2:] = upper + (0.0 - upper) / n
        return buffer
    return accumulate


def _unchanged_buffer(real):
    def progressive(width, height, accumulations, *a, device="cuda", **kw):
        return torch.zeros((height, width, 3), device=device)
    return progressive


FAULTS = {
    "frame_altered": ("integrator.pallas_smallpt",
                      "smallpt_megakernel_accumulate", _scaled_frames),
    "half_of_the_rows_left_out": ("integrator.pallas_smallpt",
                                  "smallpt_megakernel_accumulate",
                                  _half_rows),
    "state_returned_unchanged": ("apps.smallpt_app", "render_progressive",
                                 _unchanged_buffer),
}
