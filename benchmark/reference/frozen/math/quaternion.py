"""Quaternion rotations, laid out ``(x, y, z, w)``.

Port of ``bifrost3d_tpu/math/quaternion.py`` (``quat_identity``,
``quat_normalize``, ``quat_from_axis_angle``, ``quat_conjugate``,
``quat_mul``, ``quat_rotate``, ``quat_look_in``, ``quat_from_matrix``,
``quat_to_matrix``).
"""

from __future__ import annotations

import torch

from benchmark.reference.frozen.math.clip import maximum
from benchmark.reference.frozen.math.vec import cross, dot, normalize


def quat_identity(dtype=torch.float32, *, device="cpu"):
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_from_axis_angle(axis, angle):
    """Rotation of ``angle`` radians about unit ``axis`` (tensors)."""
    half = 0.5 * angle
    s = torch.sin(half)[..., None]
    return torch.cat([axis * s, torch.cos(half)[..., None]], dim=-1)


def quat_conjugate(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_mul(a, b):
    """Hamilton product a*b (apply b first, then a)."""
    av, aw = a[..., :3], a[..., 3:4]
    bv, bw = b[..., :3], b[..., 3:4]
    v = aw * bv + bw * av + cross(av, bv)
    w = aw * bw - dot(av, bv, keepdims=True)
    return torch.cat([v, w], dim=-1)


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion(s) q (q v q*)."""
    qv, qw = q[..., :3], q[..., 3:4]
    t = 2.0 * cross(qv, v)
    return v + qw * t + cross(qv, t)


def quat_look_in(direction, up=None):
    """Quaternion rotating +Z onto ``direction`` with +Y near ``up``."""
    if up is None:
        up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32,
                          device=direction.device)
    f = normalize(direction.to(torch.float32))
    r = normalize(cross(up, f))
    u = cross(f, r)
    m = torch.stack([r, u, f], dim=-1)
    return quat_from_matrix(m)


def quat_from_matrix(m):
    """Rotation matrix [..., 3, 3] → unit quaternion (branch-free
    Shepperd's method: the numerically dominant candidate is selected)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    t_w = 1.0 + m00 + m11 + m22
    t_x = 1.0 + m00 - m11 - m22
    t_y = 1.0 - m00 + m11 - m22
    t_z = 1.0 - m00 - m11 + m22

    def cand(t, a, b, c, order):
        s = torch.sqrt(maximum(t, 1e-12))
        inv = 0.5 / s
        comps = {order[0]: 0.5 * s, order[1]: a * inv, order[2]: b * inv,
                 order[3]: c * inv}
        return torch.stack([comps["x"], comps["y"], comps["z"], comps["w"]],
                           dim=-1)

    q_w = cand(t_w, m21 - m12, m02 - m20, m10 - m01, "wxyz")
    q_x = cand(t_x, m21 - m12, m01 + m10, m02 + m20, "xwyz")
    q_y = cand(t_y, m02 - m20, m01 + m10, m12 + m21, "ywxz")
    q_z = cand(t_z, m10 - m01, m02 + m20, m12 + m21, "zwxy")

    best = torch.argmax(torch.stack([t_w, t_x, t_y, t_z], dim=-1),
                        dim=-1)[..., None]
    q = torch.where(best == 0, q_w,
                    torch.where(best == 1, q_x,
                                torch.where(best == 2, q_y, q_z)))
    return quat_normalize(q)


def quat_to_matrix(q):
    """Unit quaternion → 3x3 rotation matrix (last two axes)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
    ], dim=-2)
