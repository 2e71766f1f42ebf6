"""Scale-robust self-intersection avoidance (RT Gems ch. 6).

Port of ``bifrost3d_tpu/math/ray_offset.py::offset_ray_origin``: the hit
position is nudged a fixed number of ULPs along the geometric normal by
integer arithmetic on the float bits, with a small absolute offset near
the origin. Forward only (the JAX version's custom JVP is for gradients,
which this port does not carry yet).
"""

from __future__ import annotations

import torch

_ORIGIN = 1.0 / 32.0
_FLOAT_SCALE = 1.0 / 65536.0
_INT_SCALE = 256.0


def offset_ray_origin(position, geo_normal):
    """Offset ``position`` [..., 3] along ``geo_normal`` [..., 3], which
    points toward the side the new ray travels into."""
    position, geo_normal = torch.broadcast_tensors(
        position.to(torch.float32), geo_normal.to(torch.float32))
    of_i = (_INT_SCALE * geo_normal).to(torch.int32)   # truncates toward 0
    p_int = position.contiguous().view(torch.int32)
    p_adj = p_int + torch.where(position < 0.0, -of_i, of_i)
    p_i = p_adj.view(torch.float32)
    return torch.where(torch.abs(position) < _ORIGIN,
                       position + _FLOAT_SCALE * geo_normal, p_i)
