"""TRS transforms: (translation, rotation quaternion, uniform scale).

Port of the slice's part of ``bifrost3d_tpu/math/transform.py``
(``Transform``, ``transform_look_at``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bifrost3d_tpu_torch.math.quaternion import quat_look_in


class Transform(NamedTuple):
    """translation [..., 3], rotation quaternion [..., 4] (x,y,z,w), scale [...]."""

    translation: torch.Tensor
    rotation: torch.Tensor
    scale: torch.Tensor


def transform_look_at(eye, target, up=None) -> Transform:
    """Camera-style transform at ``eye`` facing ``target`` (+Z forward);
    ``eye`` and ``target`` are float32 tensors [3]."""
    return Transform(
        translation=eye,
        rotation=quat_look_in(target - eye, up),
        scale=torch.tensor(1.0, dtype=torch.float32, device=eye.device))
