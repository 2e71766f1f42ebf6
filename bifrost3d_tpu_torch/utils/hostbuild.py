"""Host-side construction: build on the CPU, move to the device once.

Port of ``bifrost3d_tpu/utils/hostbuild.py``. A scene or asset build
(mesh packing, material tables, camera matrices, BVH) is a chain of small
array operations; on the card each would be a launch or a copy of its
own. :func:`host_build` runs the builder with the CPU as torch's default
device and then moves every tensor of what it returns to the target
device in one pass, as the reference builds scenes on the host and uploads
them in one ``handle_updates`` sync (Renderer.cpp:578-1205).
"""

from __future__ import annotations

import functools

import torch

from bifrost3d_tpu_torch.utils.tree import tree_to


def host_build(fn, *, device=None):
    """Wrap ``fn``: run it with the CPU as torch's default device, then move
    the tensors of the returned tree (NamedTuples, tuples and tensors) to
    ``device`` (the card by default). Where the target is the CPU, the
    result is returned as built."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        target = torch.device(device if device is not None else "cuda")
        with torch.device("cpu"):
            out = fn(*args, **kwargs)
        return out if target.type == "cpu" else tree_to(out, target)

    return wrapper
