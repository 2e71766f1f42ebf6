"""The plain version of the port's mesh megakernel above 1,024 triangles
(its BVH branch) against the port's own ``render_sample`` on the JAX
package's mid-size scene, and its lanes in pixel tiles against raster
lanes, on the CPU (split from tests/test_torch_megakernel_hier.py, whose
scene and plain frame it shares, so that this file's wavefront frame and
that file's JAX interpret run render on two workers).
"""

import torch

from bifrost3d_tpu_torch.integrator import pallas_mesh as tpm
from bifrost3d_tpu_torch.integrator import path_tracer as tpt
from test_torch_megakernel_hier import (  # noqa: F401  (fixtures)
    BOUNCES,
    RES,
    mid_size,
    plain_frame,
)
from torch_parity import assert_statistical_gate


def test_tiled_lanes_render_the_raster_image(mid_size):
    """A pixel's result does not depend on its lane: the plain version on
    lanes in 8 × 4 tiles, put back in raster order, equals it on raster
    lanes (the kernel hands its warps the same tiles)."""
    _, _, scene, cam = mid_size
    settings = tpt.settings_for_scene(scene, max_bounce_count=1)
    assert tpm.HIER_PIXEL_TILE == (8, 4)
    frames = []
    for tile in (tpm.HIER_PIXEL_TILE, None):
        r, g, b, rays = tpm.mesh_megakernel_reference(*tpm.megakernel_inputs(
            scene, cam, 16, 16, 2, settings, tile))
        img = torch.empty((256, 3))
        img[tpm.pixel_order(16, 16, tile, torch.device("cpu"))] = \
            torch.stack([r, g, b], dim=-1)
        frames.append((img, float(rays.sum())))
    (tiled, rays), (raster, raster_rays) = frames
    torch.testing.assert_close(tiled, raster, rtol=1e-6, atol=1e-7)
    assert rays == raster_rays > 0
    assert float(tiled.mean()) > 0.01


def test_plain_hier_matches_port_render_sample(mid_size, plain_frame):
    _, _, scene, cam = mid_size
    settings = tpt.settings_for_scene(scene, max_bounce_count=BOUNCES)
    ref = tpt.render_sample(scene, cam, RES, RES, 0, settings)
    assert_statistical_gate(plain_frame[0], ref.numpy())
