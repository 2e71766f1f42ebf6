"""RenderScene: the device-resident scene bundle the integrator consumes.

Port of ``bifrost3d_tpu/scene/render_scene.py`` (``RenderScene``,
``_assemble_soup``, ``build_render_scene``, ``refit_render_scene``,
``corner_normals``, ``_safe_unit``, ``_packed_components``,
``_packed_clusters``): the host
flattens (mesh, material, matrix) instances into one world-space triangle
soup, builds the BVH over it, and packs material and light tables, all on
one device.

A scene of at most ``PALLAS_MAX_TRIS`` triangles carries the dense table
``tri_components`` and traces through the dense kernel; a larger one
carries the BVH packing ``tri_clustered`` instead and traces through the
BVH kernel (the other two packings, ``pack_vmem`` and ``pack_clustered``,
are set by hand). An environment map becomes an ``EnvironmentLight`` (and,
with ``presample_environment``, its presampled pool), textures ride along as
a ``TextureBank``.

:func:`render_scene_from_numpy` builds a ``RenderScene`` from another
renderer's scene arrays (environment tables, pool and texture atlas
included), so two implementations can render the very same scene.
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
from bifrost3d_tpu_torch.io.texture import TextureBank
from bifrost3d_tpu_torch.lights.environment import (
    EnvironmentLight,
    PresampledEnvironmentLight,
    build_environment_light,
    presample_environment as _presample,
)
from bifrost3d_tpu_torch.lights.types import LightArray
from bifrost3d_tpu_torch.math.octahedral import (
    octahedral_decode,
    octahedral_encode,
)
from bifrost3d_tpu_torch.scene.materials import MaterialArray
from bifrost3d_tpu_torch.utils.versioned import VersionedCache


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
    # None = tint-only background.
    environment: Optional[EnvironmentLight] = None
    # The presampled pool, the default environment NEE path (built when
    # ``presample_environment`` > 0); the integrator indexes it instead of
    # searching the CDFs when RenderSettings.use_presampled_environment is
    # set.
    environment_presampled: Optional[PresampledEnvironmentLight] = None
    # None, like a bank of no texture, samples as the default.
    textures: Optional[TextureBank] = None

    @property
    def shading_models(self) -> tuple:
        """The shading models of the material table, sorted: read from
        ``materials.shading_model`` itself, so a ``_replace`` of the
        materials or a write into them is always seen."""
        return shading_models_present(self.materials)


_MODELS_CACHE = VersionedCache(64)


def shading_models_present(materials: MaterialArray) -> tuple:
    """→ the sorted shading models of ``materials``; read on the host once
    per (identity, version) of ``materials.shading_model``, so a frame
    after the first makes no host sync for it."""
    models = materials.shading_model
    key, present = _MODELS_CACHE.lookup((models,))
    if present is None:
        present = _MODELS_CACHE.store(key, (models,), tuple(sorted(set(
            int(m) for m in models.tolist()))))
    return present


def corner_normals(scene: RenderScene, prim):
    """Decoded per-corner shading normals [..., 3, 3] of triangles ``prim``
    (the attribute-interpolation decode, Types.h:58-70)."""
    return octahedral_decode(scene.tri_normals_oct[prim.long()])


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
                       environment_tint=(0.0, 0.0, 0.0),
                       textures: Optional[TextureBank] = None,
                       presample_environment: int = 0, *,
                       device) -> RenderScene:
    """instances: list of (TriangleMesh, material_index[, matrix3x4]);
    ``environment_map`` a latlong radiance map [h, w, 3] (numpy)."""
    tri_verts, tri_normals, tri_uvs, tri_tr, tri_material = \
        _assemble_soup(instances)
    for name, arr in (("positions", tri_verts), ("normals", tri_normals),
                      ("texcoords", tri_uvs), ("tint_roughness", tri_tr)):
        if not np.all(np.isfinite(arr)):
            raise ValueError(f"scene {name} contain non-finite values")
    if lights is None:
        lights = LightArray.build([], device=device)
    bvh = build_soup_bvh(tri_verts).to(device)
    env = env_pool = None
    if environment_map is not None:
        env = build_environment_light(environment_map, tint=(1.0, 1.0, 1.0),
                                      device=device)
        if presample_environment:
            env_pool = _presample(env, presample_environment)
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
        bvh=bvh,
        tri_clustered=_packed_clusters(verts, bvh),
        environment=env,
        environment_presampled=env_pool,
        textures=(textures if textures is not None
                  else TextureBank.build([], device=device)))


def refit_render_scene(scene: RenderScene, instances) -> RenderScene:
    """Transform-only scene update: rebuild the world-space soup and refit
    the existing BVH topology (``geometry.bvh.refit_bvh``) instead of a SAH
    rebuild. Materials, textures, lights and the environment are reused by
    identity.

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
    ``materials``, ``lights``, ``textures``, ``environment`` (with its
    ``distribution``) and ``environment_presampled`` (``directions``,
    ``radiances``, ``pdfs``) map their own field names to arrays, so the
    image, tint, CDFs, per-pixel pdf, pool and atlas are the other
    renderer's own. A ``bvh`` entry (the JAX
    ``BVH`` fields as numpy) is carried over, so both renderers trace the
    same tree; without one the scene has no BVH unless it is over
    ``PALLAS_MAX_TRIS`` triangles, where one is built for the packing. A
    ``tri_clustered`` entry holding the JAX package's ``VmemTriangles`` or
    ``ClusteredTriangles`` fields is carried over too, so both trace the
    same clusters; its ``HierTriangles`` has another layout than the
    port's, which packs its own.
    """
    env = arrays.get("environment")
    if env is not None:
        env = EnvironmentLight.from_numpy(env, device=device)
    pool = arrays.get("environment_presampled")
    if pool is not None:
        if env is None:
            raise ValueError("a presampled pool needs its environment")
        pool = PresampledEnvironmentLight(light=env, **{
            f: torch.tensor(np.asarray(pool[f], np.float32), device=device)
            for f in ("directions", "radiances", "pdfs")})
    textures = arrays.get("textures")
    textures = (TextureBank.build([], device=device) if textures is None
                else TextureBank.from_numpy(textures, device=device))

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
        bvh=bvh,
        tri_clustered=clustered,
        environment=env,
        environment_presampled=pool,
        textures=textures)
