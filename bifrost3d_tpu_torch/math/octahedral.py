"""Octahedral unit-vector encoding (int16 pairs).

Port of ``bifrost3d_tpu/math/octahedral.py`` (``octahedral_encode``,
``octahedral_decode``).
"""

from __future__ import annotations

import torch

from bifrost3d_tpu_torch.math.clip import clip

_RANGE = 32767.0


def _sign_not_zero(v):
    return torch.where(v >= 0.0, 1.0, -1.0)


def octahedral_encode(n):
    """Unit vectors [..., 3] float32 → int16 [..., 2]."""
    n = n.to(torch.float32)
    l1 = torch.sum(torch.abs(n), dim=-1, keepdim=True)
    p = n[..., :2] / l1
    folded = (1.0 - torch.abs(p.flip(-1))) * _sign_not_zero(p)
    enc = torch.where(n[..., 2:3] <= 0.0, folded, p)
    return torch.round(clip(enc, -1.0, 1.0) * _RANGE).to(torch.int16)


def octahedral_decode(e):
    """int16 [..., 2] → unit vectors [..., 3] float32."""
    p = e.to(torch.float32) / _RANGE
    z = 1.0 - torch.sum(torch.abs(p), dim=-1, keepdim=True)
    xy = torch.where(z < 0.0, (1.0 - torch.abs(p.flip(-1))) * _sign_not_zero(p), p)
    v = torch.cat([xy, z], dim=-1)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
