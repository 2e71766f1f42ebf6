"""Vector math over broadcastable tensors.

Port of ``bifrost3d_tpu/math/vec.py`` (``vec3``, ``dot``, ``cross``,
``length``, ``distance``, ``normalize``, ``safe_rsqrt``, ``lerp``,
``reflect``, ``refract``, ``orthonormal_basis``, ``to_local``,
``to_world``): a "Vector3" is any
tensor whose last axis has size 3, and every helper broadcasts over leading
axes.
"""

from __future__ import annotations

import torch

from benchmark.reference.frozen.math.clip import maximum


def gsafe(x, floor=0.0):
    """``max(x, max(floor, 1e-12))``: keeps sqrt operands off exactly 0,
    as the JAX package's ``_gsafe`` does for its gradients."""
    return maximum(x, max(floor, 1e-12))


def vec3(x, y, z, dtype=torch.float32, *, device=None):
    """Stack three broadcastable components into a trailing axis of size
    3; a tensor component keeps its device unless ``device`` is given."""
    return torch.stack(torch.broadcast_tensors(
        *(torch.as_tensor(c, dtype=dtype, device=device) for c in (x, y, z))),
        dim=-1)


def dot(a, b, keepdims: bool = False):
    """Inner product along the trailing axis."""
    return torch.sum(a * b, dim=-1, keepdim=keepdims)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def length_squared(v, keepdims: bool = False):
    return torch.sum(v * v, dim=-1, keepdim=keepdims)


def length(v, keepdims: bool = False):
    return torch.sqrt(length_squared(v, keepdims))


def distance(a, b):
    return length(a - b)


def safe_rsqrt(x, eps=1e-20):
    """Reciprocal square root that never divides by zero."""
    return torch.where(x > eps, 1.0, 0.0) / torch.sqrt(gsafe(x, eps))


def normalize(v, eps=1e-20):
    """Unit vector; 0 for (near-)zero input instead of NaN."""
    return v * safe_rsqrt(length_squared(v, keepdims=True), eps)


def lerp(a, b, t):
    return a + (b - a) * t


def reflect(direction, normal):
    """Mirror ``direction`` (pointing toward the surface) about ``normal``."""
    return direction - 2.0 * dot(direction, normal, keepdims=True) * normal


def refract(direction, normal, eta):
    """Refract ``direction`` (toward the surface, unit) through ``normal``,
    ``eta = n_incident / n_transmitted`` → (direction, tir mask). On total
    internal reflection the direction is the reflection, so callers can
    select without NaNs."""
    cos_i = -dot(direction, normal, keepdims=True)
    sin2_t = eta * eta * maximum(1.0 - cos_i * cos_i, 0.0)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(gsafe(1.0 - sin2_t))
    refracted = eta * direction + (eta * cos_i - cos_t) * normal
    return torch.where(tir, reflect(direction, normal), refracted), tir[..., 0]


def orthonormal_basis(normal):
    """Branch-free Duff et al. 2017 tangent basis → (tangent, bitangent)."""
    n = normal
    nx, ny, nz = n[..., 0:1], n[..., 1:2], n[..., 2:3]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    tangent = torch.cat([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    bitangent = torch.cat([b, sign + ny * ny * a, -ny], dim=-1)
    return tangent, bitangent


def to_local(v, normal):
    """World → tangent space (z = normal)."""
    t, b = orthonormal_basis(normal)
    return torch.stack([dot(v, t), dot(v, b), dot(v, normal)], dim=-1)


def to_world(v, normal):
    """Tangent space (z = normal) → world."""
    t, b = orthonormal_basis(normal)
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * normal
