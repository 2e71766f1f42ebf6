"""The least time of a SmallPT frame's work on one H100, counted from the
scene and the paths alone (``chip_smoke.py``'s count for the SmallPT
megakernel), for ``roofline.least_time_s``.

Every bounce of a live path tests each sphere (a slab-free ray-sphere
test, ``SPHERE_FLOPS``) and shades its hit once (``SHADE_FLOPS``); the
bounce count comes from the benchmark's reference on a seeded sample of
pixels and accumulations, scaled to the frame, so neither the kernel's own
counters nor its culling enter. Bytes: the sphere table read once, each
pixel's running mean read and written, and the pixel counter.
"""

from __future__ import annotations

# A ray-sphere test and one bounce's shading (chip_smoke.py).
SPHERE_FLOPS, SHADE_FLOPS = 30, 120
# A sphere's row in the kernel's table: centre, radius, emission, colour
# (10 float32) and its BSDF id (int32).
SPHERE_BYTES = 44
# A pixel's float32 RGB running mean, read and written.
PIXEL_BYTES = 24
COUNTER_BYTES = 4


def frame_work(bounces: int, lanes: int, frame_pixels: int,
               n_spheres: int) -> tuple:
    """(flops, bytes) of one frame of ``frame_pixels`` pixels from
    ``bounces``, the reference's live lanes entering a bounce summed over
    ``lanes`` sampled (pixel, accumulation) lanes."""
    flops = (bounces * frame_pixels / lanes
             * (n_spheres * SPHERE_FLOPS + SHADE_FLOPS))
    n_bytes = (n_spheres * SPHERE_BYTES + frame_pixels * PIXEL_BYTES
               + COUNTER_BYTES)
    return flops, n_bytes

