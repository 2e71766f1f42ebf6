"""RenderScene: the device-resident scene bundle the integrator consumes.

Port of ``bifrost3d_tpu/scene/render_scene.py`` (``RenderScene``,
``_assemble_soup``, ``build_render_scene``, ``_safe_unit``): the host
flattens (mesh, material, matrix) instances into one world-space triangle
soup plus material and light tables, all on one device.

On the slice every scene traces dense: ``tri_components`` is always
packed, ``bvh`` and ``tri_clustered`` are ``None``. Environment maps and
textures are not ported yet; asking for one raises.

:func:`render_scene_from_numpy` builds a ``RenderScene`` from another
renderer's scene arrays, so two implementations can render the very same
scene.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from bifrost3d_tpu_torch.geometry.mesh import (
    compute_smooth_normals,
    transform_mesh,
)
from bifrost3d_tpu_torch.geometry.pallas_intersect import pack_triangles
from bifrost3d_tpu_torch.geometry.traverse import PALLAS_MAX_TRIS
from bifrost3d_tpu_torch.lights.types import LightArray
from bifrost3d_tpu_torch.math.octahedral import octahedral_encode
from bifrost3d_tpu_torch.scene.materials import MaterialArray


class RenderScene(NamedTuple):
    tri_verts: torch.Tensor           # [t, 3, 3] world-space corners
    tri_normals_oct: torch.Tensor     # [t, 3, 2] int16 octahedral normals
    tri_uvs: torch.Tensor             # [t, 3, 2]
    tri_tint_roughness: torch.Tensor  # [t, 3, 4] per-vertex scale
    tri_material: torch.Tensor        # [t] int32
    materials: MaterialArray
    lights: LightArray
    environment_tint: torch.Tensor    # [3] background radiance
    scene_epsilon: torch.Tensor       # [] ray offset scale
    tri_components: torch.Tensor      # [16, T_pad] packed (v0, e1, e2)
    # Shading models present in the material table (host-side, sorted).
    shading_models: tuple = (0,)
    bvh: Optional[object] = None
    tri_clustered: Optional[object] = None
    # The environment map is not ported (lights/environment.py): the
    # builders raise on one, so this stays None; a scene given one is
    # ineligible for the megakernel and raises in the wavefront.
    environment: Optional[object] = None


def _assemble_soup(instances):
    """(mesh, material[, matrix3x4]) instances → world-space per-corner
    numpy arrays (verts, normals, uvs, tint_roughness, material ids)."""
    verts, normals, uvs, trs, mat_ids = [], [], [], [], []
    for inst in instances:
        mesh, mat_id = inst[0], inst[1]
        if len(inst) > 2 and inst[2] is not None:
            mesh = transform_mesh(mesh, inst[2])
        if mesh.normals is None:
            mesh = compute_smooth_normals(mesh)
        idx = np.asarray(mesh.indices)
        pos = np.asarray(mesh.positions)
        nrm = np.asarray(mesh.normals)
        uv = (np.asarray(mesh.texcoords) if mesh.texcoords is not None
              else np.zeros((pos.shape[0], 2), np.float32))
        tr = (np.asarray(mesh.tint_roughness)
              if mesh.tint_roughness is not None
              else np.ones((pos.shape[0], 4), np.float32))
        verts.append(pos[idx])
        normals.append(nrm[idx])
        uvs.append(uv[idx])
        trs.append(tr[idx])
        mat_ids.append(np.full(idx.shape[0], mat_id, np.int32))
    return (np.concatenate(verts).astype(np.float32),
            np.concatenate(normals).astype(np.float32),
            np.concatenate(uvs).astype(np.float32),
            np.concatenate(trs).astype(np.float32),
            np.concatenate(mat_ids))


def _safe_unit(n: np.ndarray) -> np.ndarray:
    """Normalize host-side; zero normals become +Z."""
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    unit = np.divide(n, norm, out=np.zeros_like(n), where=norm > 1e-20)
    unit[..., 2] = np.where(norm[..., 0] > 1e-20, unit[..., 2], 1.0)
    return unit


def _check_materials(materials: MaterialArray) -> tuple:
    """→ the sorted shading models present; raises on features that are
    not ported yet."""
    for slot in ("tint_roughness_texture", "metallic_texture",
                 "coverage_texture"):
        if bool(torch.any(getattr(materials, slot) >= 0)):
            raise NotImplementedError(
                f"textured materials ({slot}) are not ported yet")
    return tuple(sorted(set(int(m) for m in materials.shading_model.tolist())))


def _packed(tri_verts: torch.Tensor) -> torch.Tensor:
    if tri_verts.shape[0] > PALLAS_MAX_TRIS:
        raise NotImplementedError(
            f"scenes over {PALLAS_MAX_TRIS} triangles need the BVH, which is "
            "not ported yet")
    return pack_triangles(tri_verts)[0]


def build_render_scene(instances, materials: MaterialArray,
                       lights: Optional[LightArray] = None,
                       environment_map=None,
                       environment_tint=(0.0, 0.0, 0.0), *,
                       device) -> RenderScene:
    """instances: list of (TriangleMesh, material_index[, matrix3x4])."""
    if environment_map is not None:
        raise NotImplementedError("environment maps are not ported yet")
    tri_verts, tri_normals, tri_uvs, tri_tr, tri_material = \
        _assemble_soup(instances)
    for name, arr in (("positions", tri_verts), ("normals", tri_normals),
                      ("texcoords", tri_uvs), ("tint_roughness", tri_tr)):
        if not np.all(np.isfinite(arr)):
            raise ValueError(f"scene {name} contain non-finite values")
    if lights is None:
        lights = LightArray.build([], device=device)
    flat_pos = tri_verts.reshape(-1, 3)
    extent = (float(np.max(flat_pos.max(axis=0) - flat_pos.min(axis=0)))
              if flat_pos.size else 1.0)
    verts = torch.as_tensor(tri_verts, device=device)
    return RenderScene(
        tri_verts=verts,
        tri_normals_oct=octahedral_encode(
            torch.as_tensor(_safe_unit(tri_normals), device=device)),
        tri_uvs=torch.as_tensor(tri_uvs, device=device),
        tri_tint_roughness=torch.as_tensor(tri_tr, device=device),
        tri_material=torch.as_tensor(tri_material, device=device),
        materials=materials,
        lights=lights,
        environment_tint=torch.tensor(environment_tint, dtype=torch.float32,
                                      device=device),
        scene_epsilon=torch.tensor(max(extent, 1e-3) * 1e-4,
                                   dtype=torch.float32, device=device),
        tri_components=_packed(verts),
        shading_models=_check_materials(materials))


def render_scene_from_numpy(arrays: dict, *, device) -> RenderScene:
    """A RenderScene from scene arrays held as numpy.

    ``arrays`` maps the JAX ``RenderScene`` field names to numpy arrays;
    ``materials`` and ``lights`` map their own field names to arrays.
    ``environment`` must be ``None`` and a ``textures`` entry, if present,
    must hold no texture (``data`` of length 0).
    """
    if arrays.get("environment") is not None:
        raise NotImplementedError("environment maps are not ported yet")
    textures = arrays.get("textures")
    if textures is not None and np.asarray(textures["data"]).shape[0] > 0:
        raise NotImplementedError("textures are not ported yet")

    def t(name, dtype):
        return torch.tensor(np.asarray(arrays[name], dtype), device=device)

    verts = t("tri_verts", np.float32)
    materials = MaterialArray.from_numpy(arrays["materials"], device=device)
    comp = arrays.get("tri_components")
    return RenderScene(
        tri_verts=verts,
        tri_normals_oct=t("tri_normals_oct", np.int16),
        tri_uvs=t("tri_uvs", np.float32),
        tri_tint_roughness=t("tri_tint_roughness", np.float32),
        tri_material=t("tri_material", np.int32),
        materials=materials,
        lights=LightArray.from_numpy(arrays["lights"], device=device),
        environment_tint=t("environment_tint", np.float32),
        scene_epsilon=t("scene_epsilon", np.float32),
        tri_components=(_packed(verts) if comp is None
                        else t("tri_components", np.float32)),
        shading_models=_check_materials(materials))
