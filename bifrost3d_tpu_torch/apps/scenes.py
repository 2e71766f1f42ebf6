"""Built-in test scenes.

Port of ``bifrost3d_tpu/apps/scenes.py`` (``_trs``,
``create_cornell_box``, ``SCENES``), holding CornellBox only so far. Each
builder returns (RenderScene, PinholeCamera) on the given device.
"""

from __future__ import annotations

import numpy as np
import torch

from bifrost3d_tpu_torch.geometry.creation import make_box, make_plane
from bifrost3d_tpu_torch.geometry.mesh import transform_mesh
from bifrost3d_tpu_torch.lights.types import LIGHT_SPHERE, LightArray
from bifrost3d_tpu_torch.math.quaternion import (
    quat_from_axis_angle,
    quat_to_matrix,
)
from bifrost3d_tpu_torch.scene.camera import perspective_camera
from bifrost3d_tpu_torch.scene.materials import (
    COPPER_TINT,
    FLAG_THIN_WALLED,
    IRON_TINT,
    MaterialArray,
    dielectric,
    metal,
)
from bifrost3d_tpu_torch.scene.render_scene import build_render_scene

F32 = np.float32
PI = float(np.pi)
HALF_PI = PI / 2


def _trs(translation=(0, 0, 0), axis=None, angle=0.0, scale=1.0):
    """3x4 affine from translation + axis-angle + uniform scale (float32)."""
    if axis is None:
        rot = np.eye(3, dtype=F32)
    else:
        q = quat_from_axis_angle(torch.tensor(axis, dtype=torch.float32),
                                 torch.tensor(angle, dtype=torch.float32))
        rot = quat_to_matrix(q).numpy().astype(F32)
    m = np.zeros((3, 4), F32)
    m[:, :3] = rot * scale
    m[:, 3] = translation
    return m


def create_cornell_box(aspect=1.0, *, device):
    """CornellBox.h:23-120: red/green/white thin-walled 1-unit room, iron
    small box, copper tall box, sphere light (power 2, r 0.05) at the
    ceiling."""
    mats = MaterialArray.build([
        dielectric((0.98, 0.98, 0.98), 1.0, 0.02, flags=FLAG_THIN_WALLED),
        dielectric((0.98, 0.02, 0.02), 1.0, 0.02, flags=FLAG_THIN_WALLED),
        dielectric((0.02, 0.98, 0.02), 1.0, 0.02, flags=FLAG_THIN_WALLED),
        metal(IRON_TINT, 0.4),
        metal(COPPER_TINT, 0.02),
    ], device=device)
    plane = make_plane(size=1.0)
    box = make_box(size=1.0)
    tall_box = transform_mesh(box, np.asarray(
        [[1, 0, 0, 0], [0, 2, 0, 0], [0, 0, 1, 0]], F32))

    forward = (0, 0, 1)
    right = (1, 0, 0)
    up = (0, 1, 0)
    instances = [
        (plane, 0, _trs((0, -0.5, 0))),                              # floor
        (plane, 0, _trs((0, 0.5, 0), forward, PI)),                  # roof
        (plane, 0, _trs((0, 0, 0.5), right, -HALF_PI)),              # back
        (plane, 1, _trs((-0.5, 0, 0), forward, -HALF_PI)),           # left red
        (plane, 2, _trs((0.5, 0, 0), forward, HALF_PI)),             # right green
        (box, 3, _trs((0.2, -0.35, -0.2), up, PI / 6, 0.3)),         # iron box
        (tall_box, 4, _trs((-0.2, -0.2, 0.2), up, -PI / 6, 0.3)),    # copper box
    ]
    lights = LightArray.build([
        {"kind": LIGHT_SPHERE, "position": (0.0, 0.45, 0.0), "radius": 0.05,
         "power": (2.0, 2.0, 2.0)}], device=device)
    scene = build_render_scene(instances, mats, lights, device=device)
    camera = perspective_camera(eye=(0, 0, -1.5), target=(0, 0, 0),
                                fov_radians=PI / 4, aspect=aspect,
                                device=device)
    return scene, camera


SCENES = {"CornellBox": create_cornell_box}
