"""TRS transforms: (translation, rotation quaternion, uniform scale).

Port of ``bifrost3d_tpu/math/transform.py`` (``Transform``,
``transform_identity``, ``transform_point``, ``transform_vector``,
``transform_compose``, ``transform_inverse``, ``transform_delta``,
``transform_look_at``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.frozen.math.quaternion import (
    quat_conjugate,
    quat_identity,
    quat_look_in,
    quat_mul,
    quat_rotate,
)


class Transform(NamedTuple):
    """translation [..., 3], rotation quaternion [..., 4] (x,y,z,w), scale [...]."""

    translation: torch.Tensor
    rotation: torch.Tensor
    scale: torch.Tensor


def transform_identity(*, device="cpu") -> Transform:
    return Transform(
        translation=torch.zeros(3, dtype=torch.float32, device=device),
        rotation=quat_identity(device=device),
        scale=torch.tensor(1.0, dtype=torch.float32, device=device))


def transform_point(t: Transform, p):
    return t.translation + quat_rotate(t.rotation, p * t.scale[..., None])


def transform_vector(t: Transform, v):
    """Rotate and scale a direction (no translation)."""
    return quat_rotate(t.rotation, v * t.scale[..., None])


def transform_compose(outer: Transform, inner: Transform) -> Transform:
    """outer ∘ inner: apply ``inner`` first (Transform::operator*)."""
    return Transform(
        translation=transform_point(outer, inner.translation),
        rotation=quat_mul(outer.rotation, inner.rotation),
        scale=outer.scale * inner.scale)


def transform_inverse(t: Transform) -> Transform:
    inv_scale = 1.0 / t.scale
    inv_rot = quat_conjugate(t.rotation)
    inv_trans = quat_rotate(inv_rot, -t.translation) * inv_scale[..., None]
    return Transform(inv_trans, inv_rot, inv_scale)


def transform_delta(from_t: Transform, to_t: Transform) -> Transform:
    """Delta D with D ∘ from == to."""
    return transform_compose(to_t, transform_inverse(from_t))


def transform_look_at(eye, target, up=None) -> Transform:
    """Camera-style transform at ``eye`` facing ``target`` (+Z forward);
    ``eye`` and ``target`` are float32 tensors [3]."""
    return Transform(
        translation=eye,
        rotation=quat_look_in(target - eye, up),
        scale=torch.tensor(1.0, dtype=torch.float32, device=eye.device))
