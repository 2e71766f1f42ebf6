"""Scale-robust self-intersection avoidance (RT Gems ch. 6).

Port of ``bifrost3d_tpu/math/ray_offset.py::offset_ray_origin``: the hit
position is nudged a fixed number of ULPs along the geometric normal by
integer arithmetic on the float bits, with a small absolute offset near
the origin. The JAX version's custom JVP becomes a
``torch.autograd.Function`` with the same rule: the nudge is a sub-ULP
perturbation of the identity in ``position``, so the gradient passes to
``position`` unchanged and ``geo_normal`` gets none, on both branches (a
bit cast has no derivative of its own).
"""

from __future__ import annotations

import torch

_ORIGIN = 1.0 / 32.0
_FLOAT_SCALE = 1.0 / 65536.0
_INT_SCALE = 256.0


def _offset(position, geo_normal):
    position, geo_normal = torch.broadcast_tensors(
        position.to(torch.float32), geo_normal.to(torch.float32))
    of_i = (_INT_SCALE * geo_normal).to(torch.int32)   # truncates toward 0
    p_int = position.contiguous().view(torch.int32)
    p_adj = p_int + torch.where(position < 0.0, -of_i, of_i)
    p_i = p_adj.view(torch.float32)
    return torch.where(torch.abs(position) < _ORIGIN,
                       position + _FLOAT_SCALE * geo_normal, p_i)


class _OffsetRayOrigin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, position, geo_normal):
        ctx.position_shape = position.shape
        return _offset(position, geo_normal)

    @staticmethod
    def backward(ctx, grad):
        return grad.sum_to_size(ctx.position_shape), None


def offset_ray_origin(position, geo_normal):
    """Offset ``position`` [..., 3] along ``geo_normal`` [..., 3], which
    points toward the side the new ray travels into."""
    return _OffsetRayOrigin.apply(position, geo_normal)
