"""The program's side of a cell: the configuration's raw scene handed to
``bifrost3d_tpu_torch``'s own scene builder, as ``apps/scenes`` and the
viewer build theirs, and the viewer's camera and settings."""

from __future__ import annotations

import torch

from benchmark.reference.scene import RawScene


def build_scene(raw: RawScene, device):
    """→ the port's ``RenderScene`` of ``raw`` on ``device``, with the
    viewer's background tint."""
    from bifrost3d_tpu_torch.geometry.mesh import TriangleMesh
    from bifrost3d_tpu_torch.io.texture import TextureBank
    from bifrost3d_tpu_torch.lights.types import LightArray
    from bifrost3d_tpu_torch.scene.materials import MaterialArray
    from bifrost3d_tpu_torch.scene.render_scene import build_render_scene
    instances = [(TriangleMesh(m.indices, m.positions, m.normals, m.texcoords),
                  mat, matrix) for m, mat, matrix in raw.instances]
    scene = build_render_scene(
        instances, MaterialArray.build(raw.materials, device=device),
        LightArray.build(raw.lights, device=device),
        textures=TextureBank.build(raw.textures, device=device),
        device=device)
    return scene._replace(environment_tint=torch.tensor(
        raw.environment_tint, dtype=torch.float32, device=device))


def camera(pose: dict, width: int, height: int, device):
    from bifrost3d_tpu_torch.scene.camera import perspective_camera
    return perspective_camera(eye=tuple(pose["eye"]),
                              target=tuple(pose["target"]),
                              fov_radians=pose["fov_radians"],
                              aspect=width / height, device=device)


def render_settings(scene, max_bounces: int):
    from bifrost3d_tpu_torch.integrator.path_tracer import settings_for_scene
    return settings_for_scene(scene, max_bounce_count=max_bounces)
