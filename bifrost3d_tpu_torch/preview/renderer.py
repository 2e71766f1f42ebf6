"""The preview frame pipeline: G-buffer → SSAO → direct light + IBL.

Port of ``bifrost3d_tpu/preview/renderer.py`` (``_light_contribution``,
``render_preview``, ``PreviewBackend``), the counterpart of the DX11 frame
pipeline (``DX11Renderer/Renderer.cpp:336-734``): one primary-visibility
trace builds the G-buffer, SSAO modulates the ambient or environment
light, analytic lights shade as point sources with a GGX highlight, and
each light casts one hard shadow ray. Every trace goes through
``geometry/traverse`` on the scene's packing, so on a card a layer's
primary trace and each light's shadow trace launch the scene's trace
kernel: the dense one (B1) up to 65,536 triangles, the BVH one (B4) above,
or the cluster scan (B6) and the resident-cluster walk (B7) for those
packings.

A scene with a material of coverage below 1 renders 4 front-to-back
layers (T·α·shade accumulated with T ← T·(1 − α), sorted alpha blending),
each layer re-traced from the exit side of the last; an opaque scene
renders one.
"""

from __future__ import annotations

import math

import torch

from bifrost3d_tpu_torch.bsdf.fresnel import schlick_fresnel
from bifrost3d_tpu_torch.geometry.traverse import (
    intersect_scene,
    intersect_scene_any,
)
from bifrost3d_tpu_torch.lights.environment import environment_evaluate
from bifrost3d_tpu_torch.lights.types import LIGHT_DIRECTIONAL, LIGHT_SPOT
from bifrost3d_tpu_torch.math.quaternion import quat_conjugate, quat_rotate
from bifrost3d_tpu_torch.math.ray_offset import offset_ray_origin
from bifrost3d_tpu_torch.math.vec import dot, normalize
from bifrost3d_tpu_torch.preview.ssao import bilateral_blur, ssao
from bifrost3d_tpu_torch.sampling.distributions import INV_PI
from bifrost3d_tpu_torch.scene.camera import PinholeCamera, camera_rays
from bifrost3d_tpu_torch.scene.render_scene import RenderScene, corner_normals

_TRANSPARENT_LAYERS = 4
_FLAG_CUTOUT = 2


def _light_contribution(scene, position, normal, wo, tint, roughness,
                        specularity, metallic):
    """Direct lighting: per light, a point (sphere), cone (spot) or
    directional source with a hard shadow ray, diffuse + GGX highlight."""
    total = torch.zeros_like(position)
    lights = scene.lights
    for li in range(lights.count):
        is_directional = lights.kind[li] == LIGHT_DIRECTIONAL
        is_spot = lights.kind[li] == LIGHT_SPOT
        to_light = lights.position[li] - position
        d2 = torch.sum(torch.square(to_light), dim=-1)
        dist_pt = torch.sqrt(d2)
        # Distance floors at float32-denormal scale, not an absolute 1e-6,
        # so that millimetre-scale scenes keep their falloff.
        dir_pt = to_light / torch.clamp_min(dist_pt, 1e-18)[..., None]
        rad_pt = lights.power[li] / (
            4.0 * math.pi * torch.clamp_min(d2, 1e-30))[..., None]
        cos_to_axis = dot(lights.direction[li], -dir_pt)
        spot_norm = 2.0 * math.pi * torch.clamp_min(
            1.0 - lights.cos_angle[li], 1e-6)
        rad_spot = torch.where(
            (cos_to_axis > lights.cos_angle[li])[..., None],
            lights.power[li] / (spot_norm * torch.clamp_min(d2, 1e-30))[
                ..., None], 0.0)
        l_dir = torch.where(is_directional, -lights.direction[li], dir_pt)
        radiance = torch.where(is_directional, lights.power[li],
                               torch.where(is_spot, rad_spot, rad_pt))
        dist = torch.where(is_directional, 1e30, dist_pt)
        n_dot_l = torch.clamp_min(dot(normal, l_dir), 0.0)
        # One hard shadow ray from the integer-ulp offset origin.
        shadow_origin = offset_ray_origin(position, normal)
        occluded = intersect_scene_any(
            scene.bvh, scene.tri_verts, shadow_origin, l_dir,
            t_min=scene.scene_epsilon,
            t_max=torch.clamp_max(dist * 0.999, 1e30),
            tri_components=scene.tri_components,
            tri_clustered=scene.tri_clustered)
        # Diffuse + GGX highlight.
        halfway = normalize(wo + l_dir)
        n_dot_h = torch.clamp_min(dot(normal, halfway), 0.0)
        alpha = torch.clamp_min(roughness * roughness, 1e-3)
        d_term = alpha ** 2 / (math.pi * torch.square(
            n_dot_h ** 2 * (alpha ** 2 - 1) + 1) + 1e-6)
        base_spec = torch.where(metallic[..., None] > 0.5, tint,
                                torch.broadcast_to(specularity[..., None],
                                                   tint.shape))
        fres = schlick_fresnel(base_spec, torch.clamp_min(
            dot(halfway, l_dir), 0.0)[..., None])
        diffuse = tint * (1.0 - metallic[..., None]) * INV_PI
        spec = fres * (d_term / 4.0)[..., None]
        total = total + torch.where(
            (occluded | (n_dot_l <= 0))[..., None], 0.0,
            radiance * n_dot_l[..., None] * (diffuse + spec))
    return total


@torch.no_grad()
def render_preview(scene: RenderScene, camera: PinholeCamera, width: int,
                   height: int, enable_ssao: bool = True,
                   ambient=(0.08, 0.08, 0.08)):
    """One preview frame → linear HDR [height, width, 3].

    A scene with partial-coverage materials gets up to 4 front-to-back
    transparent layers (the reference's blended transparent-model pass,
    DX11Renderer/Renderer.cpp:681-734); cutouts render opaque (the preview
    fetches no texture). SSAO reads the first layer only."""
    transparent = bool(torch.any(scene.materials.coverage < 1.0))
    layers = _TRANSPARENT_LAYERS if transparent else 1
    device = scene.tri_verts.device
    ambient = torch.as_tensor(ambient, dtype=torch.float32, device=device)

    origin, direction = camera_rays(camera, width, height)
    o = origin.reshape(-1, 3)
    d = direction.reshape(-1, 3)

    color_acc = torch.zeros_like(o)
    transmittance = torch.ones(o.shape[0], dtype=torch.float32, device=device)
    alive = torch.ones(o.shape[0], dtype=torch.bool, device=device)

    for layer in range(layers):
        hit = intersect_scene(scene.bvh, scene.tri_verts, o, d,
                              t_min=scene.scene_epsilon,
                              tri_components=scene.tri_components,
                              tri_clustered=scene.tri_clustered)
        mask = hit.mask & alive
        prim = torch.clamp_min(hit.prim, 0).long()
        v = scene.tri_verts[prim]
        n = corner_normals(scene, prim)
        mat_idx = scene.tri_material[prim]
        bary = torch.stack([1.0 - hit.u - hit.v, hit.u, hit.v], dim=-1)
        position = torch.einsum("rk,rkc->rc", bary, v)
        normal = normalize(torch.einsum("rk,rkc->rc", bary, n))
        normal = torch.where(dot(normal, d, keepdims=True) > 0, -normal,
                             normal)
        wo = -d

        mats = scene.materials.gather(mat_idx)
        is_cutout = (mats.flags & _FLAG_CUTOUT) != 0
        alpha = torch.where(is_cutout, 1.0, mats.coverage)

        color = _light_contribution(scene, position, normal, wo, mats.tint,
                                    mats.roughness, mats.specularity,
                                    mats.metallic)

        # Ambient or the environment along the normal (preview fidelity).
        if scene.environment is not None:
            ambient_light = environment_evaluate(scene.environment, normal)
        else:
            ambient_light = ambient

        if enable_ssao and layer == 0:
            # View-space G-buffer for the AO pass.
            inv_rot = quat_conjugate(camera.transform.rotation)
            view_pos = quat_rotate(inv_rot,
                                   position - camera.transform.translation)
            view_nrm = quat_rotate(inv_rot, normal)
            vp = view_pos.reshape(height, width, 3)
            vn = view_nrm.reshape(height, width, 3)
            ao = ssao(vp, vn, mask.reshape(height, width))
            ao = bilateral_blur(ao, vp[..., 2]).reshape(-1)
        else:
            ao = torch.ones_like(hit.t)

        color = color + mats.tint * ambient_light * ao[..., None]
        color_acc = color_acc + torch.where(
            mask[..., None], (transmittance * alpha)[..., None] * color, 0.0)
        transmittance = torch.where(mask, transmittance * (1.0 - alpha),
                                    transmittance)
        alive = mask & (alpha < 1.0)
        if layer + 1 < layers:
            # Continue past the transparent surface from its exit side
            # (the flipped normal faces the ray's origin).
            o = torch.where(alive[..., None],
                            offset_ray_origin(position, -normal), o)

    if scene.environment is not None:
        background = environment_evaluate(scene.environment, d)
    else:
        background = torch.broadcast_to(scene.environment_tint, d.shape)
    img = color_acc + transmittance[..., None] * background
    return img.reshape(height, width, 3)


class PreviewBackend:
    """The stateless preview renderer behind the progressive-backend
    protocol (``render``, ``reset``, ``accumulations``), as the reference's
    DX11OptiXAdaptor hosts both renderer kinds
    (``DX11OptiXAdaptor/Adaptor.cpp:39-130``)."""

    def __init__(self, scene, camera, width: int, height: int,
                 enable_ssao: bool = True):
        self.scene = scene
        self.camera = camera
        self.width = width
        self.height = height
        self.enable_ssao = enable_ssao
        self.accumulations = 0

    def reset(self) -> None:
        self.accumulations = 0

    def render(self):
        self.accumulations += 1
        return render_preview(self.scene, self.camera, self.width,
                              self.height, enable_ssao=self.enable_ssao)
