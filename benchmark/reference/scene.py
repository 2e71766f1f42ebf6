"""A configuration's scene, made from its JSON description alone.

``raw_scene`` turns ``configs/<name>.json`` into plain numpy data — meshes
with their instance matrices, material and light records, texture images,
the background tint and the camera's pose — which the harness hands to the
program (``bifrost3d_tpu_torch``'s scene builder) and to the reference
alike. ``soup`` and ``tables`` work out the reference's own triangle soup
and material, light and texture tables from that data; nothing here reads
what the program made.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.frozen.geometry.creation import (
    TriangleMesh,
    make_box,
    make_plane,
    make_sphere,
    transform_mesh,
)
from benchmark.reference.frozen.math.quaternion import (
    quat_from_axis_angle,
    quat_to_matrix,
)

F32 = np.float32
LIGHT_KINDS = {"sphere": 0, "spot": 1, "directional": 2}
FLAG_THIN_WALLED, FLAG_CUTOUT = 1, 2
# Material record defaults (``MaterialArray.build``'s).
MATERIAL_DEFAULTS = dict(
    shading_model=0, tint=(1.0, 1.0, 1.0), roughness=0.5, specularity=0.04,
    metallic=0.0, coat=0.0, coat_roughness=0.0, coverage=1.0,
    transmission=0.0, emission=(0.0, 0.0, 0.0), flags=0,
    tint_roughness_texture=-1, metallic_texture=-1, coverage_texture=-1)


class RawScene(NamedTuple):
    instances: list      # [(TriangleMesh, material index, 3x4 matrix)]
    materials: list      # [dict] as MaterialArray.build takes them
    lights: list         # [dict] with an integer "kind"
    textures: list       # [dict(image=[h, w, 4] float32, filter=int)]
    environment_tint: tuple
    camera: dict         # eye, target, fov_radians


def _trs(translation=(0, 0, 0), axis=None, angle=0.0, scale=1.0):
    """3x4 affine from translation + axis-angle + uniform scale (float32),
    as ``apps/scenes._trs``."""
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


def _mesh(spec: dict) -> TriangleMesh:
    kind = spec["kind"]
    if kind == "plane":
        mesh = make_plane(size=spec["size"])
    elif kind == "box":
        mesh = make_box(size=spec["size"])
    elif kind == "sphere":
        mesh = make_sphere(radius=spec["radius"], slices=spec["slices"],
                           stacks=spec["stacks"])
    else:
        raise ValueError(f"unknown mesh kind {kind!r}")
    if "matrix" in spec:
        mesh = transform_mesh(mesh, np.asarray(spec["matrix"], F32))
    if "uv_scale" in spec:
        mesh = mesh._replace(texcoords=(np.asarray(mesh.texcoords) - 0.5)
                             * spec["uv_scale"])
    return mesh


def raw_scene(cfg: dict) -> RawScene:
    meshes = {name: _mesh(spec) for name, spec in cfg["meshes"].items()}
    instances = [(meshes[i["mesh"]], int(i["material"]),
                  _trs(i.get("translation", (0, 0, 0)), i.get("axis"),
                       i.get("angle", 0.0), i.get("scale", 1.0)))
                 for i in cfg["instances"]]
    lights = []
    for li in cfg["lights"]:
        li = dict(li, kind=LIGHT_KINDS[li["kind"]])
        if "direction" in li:
            # Unit in float32, as the upstream scenes state it.
            d = np.asarray(li["direction"], F32)
            d /= np.linalg.norm(d)
            li["direction"] = tuple(d)
        lights.append(li)
    textures = [dict(image=np.asarray(t["image"], F32), filter=int(t["filter"]))
                for t in cfg["textures"]]
    return RawScene(instances, [dict(m) for m in cfg["materials"]], lights,
                    textures, tuple(cfg["environment_tint"]),
                    dict(cfg["camera"]))


def soup(raw: RawScene):
    """World-space triangles → (verts [t, 3, 3], normals [t, 3, 3], uvs [t,
    3, 2], material [t]), as ``render_scene._assemble_soup`` lays them out."""
    verts, normals, uvs, mats = [], [], [], []
    for mesh, mat_id, matrix in raw.instances:
        mesh = transform_mesh(mesh, matrix)
        idx = np.asarray(mesh.indices)
        verts.append(np.asarray(mesh.positions)[idx])
        normals.append(np.asarray(mesh.normals)[idx])
        uvs.append(np.asarray(mesh.texcoords)[idx])
        mats.append(np.full(idx.shape[0], mat_id, np.int32))
    return (np.concatenate(verts).astype(F32),
            np.concatenate(normals).astype(F32),
            np.concatenate(uvs).astype(F32), np.concatenate(mats))


def material_rows(raw: RawScene) -> np.ndarray:
    """[m, 16] records: tint 0-2, roughness 3, specularity 4, metallic 5,
    thin-walled 6 (cutouts too), emission 7-9, coverage 10, coat 11, coat
    roughness 12, shading model 13."""
    rows = np.zeros((len(raw.materials), 16), F32)
    for i, given in enumerate(raw.materials):
        m = dict(MATERIAL_DEFAULTS, **given)
        rows[i, 0:3] = m["tint"]
        rows[i, 3] = m["roughness"]
        rows[i, 4] = m["specularity"]
        rows[i, 5] = m["metallic"]
        rows[i, 6] = float((int(m["flags"]) & (FLAG_THIN_WALLED | FLAG_CUTOUT)) != 0)
        rows[i, 7:10] = m["emission"]
        rows[i, 10] = m["coverage"]
        rows[i, 11] = m["coat"]
        rows[i, 12] = m["coat_roughness"]
        rows[i, 13] = m["shading_model"]
    return rows


def scene_epsilon(verts: np.ndarray) -> float:
    """The ray offset: 1e-4 of the soup's largest box side (at least
    1e-3), as ``render_scene.build_render_scene`` sets it."""
    flat = verts.reshape(-1, 3)
    extent = float(np.max(flat.max(axis=0) - flat.min(axis=0))) \
        if flat.size else 1.0
    return float(F32(max(extent, 1e-3) * 1e-4))
