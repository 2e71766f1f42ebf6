"""Pinhole camera: +Z-forward perspective projection and ray generation.

Port of ``bifrost3d_tpu/scene/camera.py`` (``PinholeCamera``,
``perspective_projection``, ``orthographic_projection``,
``perspective_camera``,
``camera_ray_directions``, ``camera_rays``, ``project_to_screen``): near-
and far-plane NDC
points are unprojected through the inverse projection and rotated into
world space, and world points projected back.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.frozen.math.quaternion import quat_rotate
from benchmark.reference.frozen.math.transform import (
    Transform,
    transform_inverse,
    transform_look_at,
    transform_point,
)
from benchmark.reference.frozen.math.vec import normalize


class PinholeCamera(NamedTuple):
    """World transform + projection and its inverse (NDC → view space)."""

    transform: Transform
    projection: torch.Tensor          # [4, 4]
    inverse_projection: torch.Tensor  # [4, 4]


def perspective_projection(near, far, fov_radians, aspect, *, device):
    """+Z-forward perspective matrix and its exact inverse (Camera.cpp:237-266)."""
    f = 1.0 / torch.tan(torch.tensor(fov_radians * 0.5, dtype=torch.float32))
    a = (far + near) / (near - far)
    b = (2.0 * far * near) / (near - far)
    proj = torch.zeros((4, 4), dtype=torch.float32)
    proj[0, 0] = f / aspect
    proj[1, 1] = f
    proj[2, 2] = -a
    proj[2, 3] = b
    proj[3, 2] = 1.0
    inv = torch.zeros((4, 4), dtype=torch.float32)
    inv[0, 0] = aspect / f
    inv[1, 1] = 1.0 / f
    inv[2, 3] = 1.0
    inv[3, 2] = 1.0 / b
    inv[3, 3] = a / b
    return proj.to(device), inv.to(device)


def orthographic_projection(width, height, depth, *, device):
    """Orthographic matrix and its inverse (Camera.cpp:268-287)."""
    proj = torch.zeros((4, 4), dtype=torch.float32)
    proj[0, 0] = 2.0 / width
    proj[1, 1] = 2.0 / height
    proj[2, 2] = 2.0 / depth
    proj[2, 3] = -1.0
    proj[3, 3] = 1.0
    inv = torch.zeros((4, 4), dtype=torch.float32)
    inv[0, 0] = 0.5 * width
    inv[1, 1] = 0.5 * height
    inv[2, 2] = 0.5 * depth
    inv[2, 3] = 0.5 * depth
    inv[3, 3] = 1.0
    return proj.to(device), inv.to(device)


def perspective_camera(eye, target, fov_radians=math.pi / 3, aspect=1.0,
                       near=0.1, far=1000.0, up=None, *,
                       device) -> PinholeCamera:
    proj, inv = perspective_projection(near, far, fov_radians, aspect,
                                       device=device)
    eye = torch.tensor(eye, dtype=torch.float32, device=device)
    target = torch.tensor(target, dtype=torch.float32, device=device)
    if up is not None:
        up = torch.tensor(up, dtype=torch.float32, device=device)
    return PinholeCamera(transform=transform_look_at(eye, target, up),
                         projection=proj, inverse_projection=inv)


def camera_from_numpy(arrays: dict, *, device) -> PinholeCamera:
    """From numpy arrays keyed translation, rotation, scale, projection and
    inverse_projection (e.g. another renderer's camera)."""
    def t(name):
        return torch.tensor(np.asarray(arrays[name], np.float32),
                               device=device)
    return PinholeCamera(
        transform=Transform(t("translation"), t("rotation"), t("scale")),
        projection=t("projection"), inverse_projection=t("inverse_projection"))


def camera_ray_directions(camera: PinholeCamera, viewport_points):
    """Viewport points [..., 2] in [0,1]² → (origins [..., 3], dirs [..., 3])."""
    ndc_xy = viewport_points * 2.0 - 1.0
    ones = torch.ones_like(ndc_xy[..., :1])
    near4 = torch.cat([ndc_xy, -ones, ones], dim=-1)
    inv = camera.inverse_projection
    scaled_near = near4 @ inv.T
    ray_near = scaled_near[..., :3] / scaled_near[..., 3:4]
    scaled_far = scaled_near + 2.0 * inv[:, 2]
    ray_far = scaled_far[..., :3] / scaled_far[..., 3:4]
    dir_view = normalize(ray_far - ray_near)
    t = camera.transform
    origin = t.translation + quat_rotate(t.rotation, ray_near * t.scale)
    direction = quat_rotate(t.rotation, dir_view)
    return origin, direction


def camera_rays(camera: PinholeCamera, width: int, height: int, jitter=None):
    """One ray per pixel → (origins, directions) [h, w, 3]. ``jitter``
    [h, w, 2] in [0, 1)² (default: pixel centres). Row 0 is the top of the
    image (viewport v = 1), the reference's image convention."""
    device = camera.projection.device
    x = torch.arange(width, dtype=torch.float32, device=device)[None, :, None]
    y = torch.arange(height, dtype=torch.float32, device=device)[:, None, None]
    if jitter is None:
        jitter = torch.full((height, width, 2), 0.5, dtype=torch.float32,
                            device=device)
    u = (x + jitter[..., 0:1]) / width
    v = 1.0 - (y + jitter[..., 1:2]) / height
    return camera_ray_directions(camera, torch.cat([u, v], dim=-1))


def project_to_screen(camera: PinholeCamera, point):
    """World point [..., 3] → (uv [..., 2] in [0,1]², w [...]).

    The inverse of :func:`camera_ray_directions` (``w`` > 0 means in front
    of the camera: the clip-space w, positive along the +Z view axis).
    Differentiable in ``point``: the edge-sampled geometry gradients
    (``diff/mesh_edge_grad.py``) take their screen-space edge velocities
    through it.
    """
    view = transform_point(transform_inverse(camera.transform), point)
    v4 = torch.cat([view, torch.ones_like(view[..., :1])], dim=-1)
    clip = v4 @ camera.projection.T
    w = clip[..., 3]
    safe_w = torch.where(torch.abs(w) < 1e-9, 1e-9, w)
    ndc = clip[..., :2] / safe_w[..., None]
    return (ndc + 1.0) * 0.5, w
