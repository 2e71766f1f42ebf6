"""The least time of a progressive frame's work on one H100, counted from
the scene and the paths alone.

A frame's work is what its paths need, whatever kernel runs them: every
path segment and shadow ray is one closest- or any-hit query against an
ideal binary BVH over the scene's triangles, every shaded vertex the
shading operations of ``chip_smoke.shade_ops`` (copied below with their
constants), every pixel one camera lane. The path counts come from the
benchmark's reference on a seeded sample of pixels, so a redesign of the
trace, the culling or the kernel cannot move the yardstick. Bytes count
each input table read once and the image written once.
"""

from __future__ import annotations

import math

# Published peaks of one H100 SXM: HBM bytes/s and float32 FLOP/s outside
# the tensor cores (NVIDIA's data sheet, at its 700 W limit).
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 67e12
# A Möller–Trumbore triangle test and a slab box test (chip_smoke.py).
MT_FLOPS, BOX_FLOPS = 50, 24
# Operations of one megakernel iteration that shades a hit, outside its
# traces (chip_smoke.py, counted once from csrc/mesh_megakernel.cu: two
# path_rng_4d draws, attributes and frame, shading creation, the BSDF
# sample, light hits, offsets and throughput); per RIS candidate a light
# sample, an evaluation, MIS and the reservoir; the coat lobe; the texture
# or coverage fetch.
MEGA_SHADE_OPS, MEGA_RIS_OPS = 1600, 360
MEGA_COAT_OPS, MEGA_COAT_RIS_OPS, MEGA_EXTRAS_OPS = 150, 120, 100
# A camera lane: one path_rng_4d draw (~450) and the ray through the
# camera's matrices (~100).
CAMERA_OPS = 550
# Each query of an ideal BVH tests two boxes per level and two triangles.
LEAF_TRIANGLES = 2


def shade_ops(ris_count: int, has_coat: bool, extras: bool) -> int:
    """``chip_smoke.shade_ops`` for a scene with these properties."""
    ops = MEGA_SHADE_OPS + MEGA_RIS_OPS * ris_count
    if has_coat or extras:
        ops += MEGA_COAT_OPS + MEGA_COAT_RIS_OPS * ris_count
    return ops + (MEGA_EXTRAS_OPS if extras else 0)


def query_flops(n_tris: int) -> int:
    """One ray against an ideal binary BVH over ``n_tris`` triangles."""
    levels = math.ceil(math.log2(max(n_tris, 2)))
    return 2 * levels * BOX_FLOPS + LEAF_TRIANGLES * MT_FLOPS


def frame_work(counts: dict, lanes: int, frame_pixels: int, n_tris: int,
               ris_count: int, has_coat: bool, extras: bool,
               table_bytes: int) -> tuple:
    """(flops, bytes) of one frame of ``frame_pixels`` pixels from the
    reference's ``counts`` over ``lanes`` sampled (pixel, accumulation)
    lanes."""
    scale = frame_pixels / lanes
    queries = counts.get("traces", 0) + counts.get("shadow_rays", 0)
    flops = scale * (queries * query_flops(n_tris)
                     + counts.get("shaded", 0)
                     * shade_ops(ris_count, has_coat, extras)
                     + lanes * CAMERA_OPS)
    image_bytes = frame_pixels * 3 * 4
    return flops, table_bytes + image_bytes


def least_time_s(flops: float, n_bytes: float) -> float:
    return max(flops / PEAK_FLOPS, n_bytes / PEAK_BYTES)
