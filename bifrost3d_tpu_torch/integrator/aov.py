"""Auxiliary output variables (AOVs).

Port of ``bifrost3d_tpu/integrator/aov.py`` (``render_aovs``), the
counterpart of the reference's AOV ray-generation programs
(``SimpleRGPs.cu:227-340``): depth (normalised by near/far), albedo (the
shading model's rho), tint, roughness, shading normal and primitive id
(bit-reversed, Utils.h:304-329), all from one primary-ray trace.

The trace is ``intersect_scene`` on the scene's packing: on a card one
launch of the dense kernel (B1) or, above 65,536 triangles, of the BVH
kernel (B4); on the CPU their plain versions.
"""

from __future__ import annotations

import torch

from bifrost3d_tpu_torch.geometry.traverse import intersect_scene
from bifrost3d_tpu_torch.integrator.path_tracer import _create_shading
from bifrost3d_tpu_torch.math.vec import dot, normalize, to_local
from bifrost3d_tpu_torch.sampling.hashes import reverse_bits
from bifrost3d_tpu_torch.scene.camera import PinholeCamera, camera_rays
from bifrost3d_tpu_torch.scene.materials import (
    SHADING_DEFAULT,
    SHADING_DIFFUSE,
    SHADING_TRANSMISSIVE,
)
from bifrost3d_tpu_torch.scene.render_scene import RenderScene, corner_normals

_ALL_MODELS = (SHADING_DEFAULT, SHADING_DIFFUSE, SHADING_TRANSMISSIVE)


@torch.no_grad()
def render_aovs(scene: RenderScene, camera: PinholeCamera, width: int,
                height: int, near: float = 0.1, far: float = 100.0) -> dict:
    """→ dict of AOV images [h, w] or [h, w, 3] from one primary-ray pass."""
    origin, direction = camera_rays(camera, width, height)
    o = origin.reshape(-1, 3)
    d = direction.reshape(-1, 3)

    hit = intersect_scene(scene.bvh, scene.tri_verts, o, d,
                          t_min=scene.scene_epsilon,
                          tri_components=scene.tri_components,
                          tri_clustered=scene.tri_clustered)
    mask = hit.mask
    prim = torch.clamp_min(hit.prim, 0).long()
    n = corner_normals(scene, prim)
    mat_idx = scene.tri_material[prim]
    bary = torch.stack([1.0 - hit.u - hit.v, hit.u, hit.v], dim=-1)
    shading_normal = normalize(torch.einsum("rk,rkc->rc", bary, n))
    shading_normal = torch.where(dot(shading_normal, d, keepdims=True) > 0,
                                 -shading_normal, shading_normal)

    # Depth normalised to [0, 1] by near/far (SimpleRGPs.cu:227-259).
    depth = torch.clamp((torch.where(mask, hit.t, far) - near) / (far - near),
                        0.0, 1.0)

    mats = scene.materials.gather(mat_idx)
    tint, roughness = mats.tint, mats.roughness

    # Albedo: rho of the shading model, every model built on every lane as
    # JAX's AOV pass builds them.
    wo = to_local(-d, shading_normal)
    bundle = _create_shading(_ALL_MODELS, mats.shading_model, tint, roughness,
                             mats.specularity, mats.metallic, mats.coat,
                             mats.coat_roughness, wo[..., 2])
    abs_cos = torch.abs(wo[..., 2])
    model = bundle.model[..., None]
    albedo = torch.where(
        model == SHADING_DIFFUSE, bundle.diffuse.rho(abs_cos),
        torch.where(model == SHADING_TRANSMISSIVE,
                    bundle.transmissive.rho(abs_cos),
                    bundle.default.rho(abs_cos)))

    # Primitive id: bit-reversed and split into three 10-bit channels
    # (Utils.h:304-329).
    code = reverse_bits(prim)
    prim_color = torch.stack([(code >> s) & 0x3FF for s in (0, 10, 20)],
                             dim=-1).to(torch.float32) / 1023.0

    def img(x, channels=None):
        return x.reshape((height, width) if channels is None
                         else (height, width, channels))

    hit3 = mask[..., None]
    return {
        "depth": img(depth),
        "albedo": img(torch.where(hit3, albedo, 0.0), 3),
        "tint": img(torch.where(hit3, tint, 0.0), 3),
        "roughness": img(torch.where(mask, roughness, 0.0)),
        "shading_normal": img(torch.where(hit3, shading_normal, 0.0), 3),
        "primitive_id": img(torch.where(hit3, prim_color, 0.0), 3),
    }
