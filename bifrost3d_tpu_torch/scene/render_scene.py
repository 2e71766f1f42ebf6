"""RenderScene: the device-resident scene bundle the integrator consumes.

Port of ``bifrost3d_tpu/scene/render_scene.py`` (``RenderScene``,
``_assemble_soup``, ``build_render_scene``, ``refit_render_scene``,
``_safe_unit``, ``_packed_components``, ``_packed_clusters``): the host
flattens (mesh, material, matrix) instances into one world-space triangle
soup, builds the BVH over it, and packs material and light tables, all on
one device.

A scene of at most ``PALLAS_MAX_TRIS`` triangles carries the dense table
``tri_components`` and traces through the dense kernel; a larger one
carries the BVH packing ``tri_clustered`` instead and traces through the
BVH kernel (the other two packings, ``pack_vmem`` and ``pack_clustered``,
are set by hand). Environment maps and textures are not ported yet; asking for
one raises.

:func:`render_scene_from_numpy` builds a ``RenderScene`` from another
renderer's scene arrays, so two implementations can render the very same
scene.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from bifrost3d_tpu_torch.geometry import traverse
from bifrost3d_tpu_torch.geometry.bvh import (
    BVH,
    build_soup_bvh,
    refit_bvh,
)
from bifrost3d_tpu_torch.geometry.mesh import (
    compute_smooth_normals,
    transform_mesh,
)
from bifrost3d_tpu_torch.geometry.pallas_bvh import (
    HierTriangles,
    pack_hierarchical,
)
from bifrost3d_tpu_torch.geometry.pallas_bvh_vmem import VmemTriangles
from bifrost3d_tpu_torch.geometry.pallas_clustered import ClusteredTriangles
from bifrost3d_tpu_torch.geometry.pallas_intersect import pack_triangles
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
    # [16, T_pad] packed (v0, e1, e2) for the dense kernel; None on a
    # scene over PALLAS_MAX_TRIS triangles.
    tri_components: Optional[torch.Tensor]
    # Shading models present in the material table (host-side, sorted).
    shading_models: tuple = (0,)
    # The BVH over the soup, on the scene's device (None on a scene
    # carried over without one).
    bvh: Optional[BVH] = None
    # The packing of a scene the dense kernel does not take (None on one it
    # does): the BVH kernel's by default; ``scene._replace(tri_clustered=
    # pack_vmem(...))`` or ``pack_clustered(...)`` puts a scene of any size
    # on the resident-cluster walk or the cluster scan instead
    # (``geometry/traverse.py`` dispatches on the type).
    tri_clustered: Optional[Union[HierTriangles, VmemTriangles,
                                  ClusteredTriangles]] = None
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


def _packed_components(tri_verts: torch.Tensor) -> Optional[torch.Tensor]:
    # PALLAS_MAX_TRIS is read from its module at call time, so a test can
    # lower it to send a small scene down the BVH path.
    if tri_verts.shape[0] > traverse.PALLAS_MAX_TRIS:
        return None    # large scene: the BVH packing takes over
    return pack_triangles(tri_verts)[0]


def _packed_clusters(tri_verts: torch.Tensor,
                     bvh: Optional[BVH]) -> Optional[HierTriangles]:
    if tri_verts.shape[0] <= traverse.PALLAS_MAX_TRIS:
        return None    # small scene: dense streaming
    return pack_hierarchical(tri_verts, bvh)


def _extent(tri_verts: np.ndarray) -> float:
    flat_pos = tri_verts.reshape(-1, 3)
    return (float(np.max(flat_pos.max(axis=0) - flat_pos.min(axis=0)))
            if flat_pos.size else 1.0)


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
    bvh = build_soup_bvh(tri_verts).to(device)
    extent = _extent(tri_verts)
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
        tri_components=_packed_components(verts),
        shading_models=_check_materials(materials),
        bvh=bvh,
        tri_clustered=_packed_clusters(verts, bvh))


def refit_render_scene(scene: RenderScene, instances) -> RenderScene:
    """Transform-only scene update: rebuild the world-space soup and refit
    the existing BVH topology (``geometry.bvh.refit_bvh``) instead of a SAH
    rebuild. Materials and lights are reused by identity.

    ``instances`` must bind the same meshes in the same order as the
    original build (only the matrices may differ); the triangle count is
    checked.
    """
    tri_verts, tri_normals, tri_uvs, tri_tr, tri_material = \
        _assemble_soup(instances)
    if tri_verts.shape[0] != int(scene.tri_verts.shape[0]):
        raise ValueError("refit requires identical instance topology; "
                         "rebuild instead")
    if scene.bvh is None:
        raise ValueError("refit needs a scene that carries its BVH")
    device = scene.tri_verts.device
    flat_pos = tri_verts.reshape(-1, 3)
    flat_idx = np.arange(flat_pos.shape[0], dtype=np.int32).reshape(-1, 3)
    bvh = refit_bvh(scene.bvh, flat_pos, flat_idx)
    verts = torch.as_tensor(tri_verts, device=device)
    return scene._replace(
        tri_verts=verts,
        tri_normals_oct=octahedral_encode(
            torch.as_tensor(_safe_unit(tri_normals), device=device)),
        tri_uvs=torch.as_tensor(tri_uvs, device=device),
        tri_tint_roughness=torch.as_tensor(tri_tr, device=device),
        tri_material=torch.as_tensor(tri_material, device=device),
        scene_epsilon=torch.tensor(max(_extent(tri_verts), 1e-3) * 1e-4,
                                   dtype=torch.float32, device=device),
        tri_components=_packed_components(verts),
        bvh=bvh,
        tri_clustered=_packed_clusters(verts, bvh))


def render_scene_from_numpy(arrays: dict, *, device) -> RenderScene:
    """A RenderScene from scene arrays held as numpy.

    ``arrays`` maps the JAX ``RenderScene`` field names to numpy arrays;
    ``materials`` and ``lights`` map their own field names to arrays.
    ``environment`` must be ``None`` and a ``textures`` entry, if present,
    must hold no texture (``data`` of length 0). A ``bvh`` entry (the JAX
    ``BVH`` fields as numpy) is carried over, so both renderers trace the
    same tree; without one the scene has no BVH unless it is over
    ``PALLAS_MAX_TRIS`` triangles, where one is built for the packing. A
    ``tri_clustered`` entry holding the JAX package's ``VmemTriangles`` or
    ``ClusteredTriangles`` fields is carried over too, so both trace the
    same clusters; its ``HierTriangles`` has another layout than the
    port's, which packs its own.
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
    bvh = arrays.get("bvh")
    if bvh is not None:
        bvh = BVH.from_numpy(bvh, device=device)
    elif verts.shape[0] > traverse.PALLAS_MAX_TRIS:
        bvh = build_soup_bvh(verts).to(device)
    clustered = arrays.get("tri_clustered") or {}
    if "tri_planes" in clustered:
        clustered = VmemTriangles.from_numpy(clustered, device=device)
    elif "cluster_boxes" in clustered:
        clustered = ClusteredTriangles.from_numpy(clustered, device=device)
    else:
        clustered = _packed_clusters(verts, bvh)
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
        tri_components=(_packed_components(verts) if comp is None
                        else t("tri_components", np.float32)),
        shading_models=_check_materials(materials),
        bvh=bvh,
        tri_clustered=clustered)
