"""The SmallPT kernel's inputs and running mean, on the CPU.

A progressive frame on the card is one launch: the kernel's sphere table
and camera are cached per (identity, version) of the scene's tensors and
the frame's size, and the kernel lerps its frame into the running mean in
place. Here the cache is held to its keys, and the accumulate entry's plain
version to the app's torch line.
"""

import numpy as np
import pytest
import torch

from bifrost3d_tpu_torch.apps import smallpt_app
from bifrost3d_tpu_torch.integrator import pallas_smallpt as spt
from bifrost3d_tpu_torch.scene.spheres import smallpt_scene
import torch_parity  # noqa: F401  (one torch thread per worker)

W, H = 24, 16


def test_kernel_inputs_are_cached_until_the_scene_changes():
    scene = smallpt_scene(device="cpu")
    first = spt.kernel_inputs(scene, W, H)
    assert spt.kernel_inputs(scene, W, H) is first
    sph, bsdf, cam = first
    ref_sph, ref_bsdf = spt.sphere_table(scene)
    assert torch.equal(sph, ref_sph) and torch.equal(bsdf, ref_bsdf)
    assert cam.shape == (12,) and cam.dtype == torch.float32
    # Another frame size is another camera (cx depends on the aspect).
    other = spt.kernel_inputs(scene, 2 * W, H)
    assert other is not first and not torch.equal(other[2], cam)
    # An in-place write to any scene tensor is a miss, with the new values.
    scene.position[8, 1] -= 1.0
    moved = spt.kernel_inputs(scene, W, H)
    assert moved is not first
    assert float(moved[0][8, 1]) == float(first[0][8, 1]) - 1.0
    scene.bsdf[0] = 1
    assert int(spt.kernel_inputs(scene, W, H)[1][0]) == 1


def test_kernel_inputs_refuse_too_many_spheres():
    scene = smallpt_scene(device="cpu")
    many = type(scene)(*(torch.cat([f] * 8) for f in scene))    # 72 spheres
    with pytest.raises(ValueError, match="spheres outside"):
        spt.kernel_inputs(many, W, H)


def test_plain_accumulate_is_the_apps_torch_lerp():
    scene = smallpt_scene(device="cpu")
    buffer = torch.zeros((H, W, 3))
    ref = torch.zeros((H, W, 3))
    for n in (1, 2, 3):
        out = spt.smallpt_megakernel_accumulate(scene, W, H, n, buffer)
        assert out is buffer
        frame = spt.smallpt_megakernel_reference(scene, W, H, n)
        ref = ref + (frame - ref) / n
        np.testing.assert_array_equal(buffer.numpy().view(np.int32),
                                      ref.numpy().view(np.int32))
    with pytest.raises(ValueError, match=">= 1"):
        spt.smallpt_megakernel_accumulate(scene, W, H, 0, buffer)


def test_app_is_the_running_mean_of_its_frames():
    img = smallpt_app.render_progressive(W, H, 3, quiet=True, device="cpu")
    scene = smallpt_scene(device="cpu")
    ref = torch.zeros((H, W, 3))
    for n in (1, 2, 3):
        ref = ref + (spt.render_smallpt_megakernel(scene, W, H, n) - ref) / n
    assert torch.equal(img, ref)
