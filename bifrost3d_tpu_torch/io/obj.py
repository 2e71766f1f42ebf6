"""Wavefront OBJ + MTL loader.

Port of ``bifrost3d_tpu/io/obj.py`` (``_parse_mtl``, ``_assemble_group``,
``load_obj``), the counterpart of the reference's ObjLoader
(``ObjLoader.cpp:32-315``):
- v/vn/vt/f with negative indices and polygon fan triangulation, through
  the native tokenizer (:mod:`bifrost3d_tpu_torch.io.native_obj`) or, where
  it cannot be built or ``use_native`` is off, in Python;
- MTL conversion as the reference's: Blinn-Phong shininess → GGX roughness
  via ``alpha² = 2/(shininess+2)`` (ObjLoader.cpp:167-168), ``illum`` 3 or
  5 → metallic = 1 (ObjLoader.cpp:169-171), ``d`` / ``Tr`` → coverage,
  ``Ke`` → emission.

``map_Kd`` / ``map_d`` are kept as path strings in the material dict, as
the JAX package keeps them; ``MaterialArray.build`` rejects such a dict
(a path is not a finite number), in both packages.

Returns (meshes, materials): meshes a list of (TriangleMesh with numpy
buffers, material_index, name).
"""

from __future__ import annotations

import os

import numpy as np

from bifrost3d_tpu_torch.geometry.mesh import TriangleMesh
from bifrost3d_tpu_torch.scene.materials import DEFAULT_SPECULARITY


def _default_material():
    return dict(tint=(0.8, 0.8, 0.8), roughness=0.8)


def _parse_mtl(path):
    materials = {}
    cur = None
    if not os.path.exists(path):
        return materials
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                cur = dict(tint=(0.8, 0.8, 0.8), roughness=0.8,
                           specularity=DEFAULT_SPECULARITY)
                materials[parts[1]] = cur
            elif cur is None:
                continue
            elif key == "Kd":
                cur["tint"] = tuple(float(p) for p in parts[1:4])
            elif key == "Ke":
                e = tuple(float(p) for p in parts[1:4])
                if any(v > 0 for v in e):
                    cur["emission"] = e
            elif key == "Ns":
                # Blinn-Phong exponent → GGX alpha (ObjLoader.cpp:167-168).
                alpha_sq = 2.0 / (float(parts[1]) + 2.0)
                cur["roughness"] = float(np.sqrt(np.sqrt(alpha_sq)))
            elif key == "d":
                cur["coverage"] = float(parts[1])
            elif key == "Tr":
                cur["coverage"] = 1.0 - float(parts[1])
            elif key == "illum":
                if int(parts[1]) in (3, 5):
                    cur["metallic"] = 1.0  # ObjLoader.cpp:169-171
            elif key == "map_Kd":
                cur["tint_texture_path"] = parts[-1]
            elif key == "map_d":
                cur["coverage_texture_path"] = parts[-1]
    return materials


def _assemble_group(positions, normals, uvs, fl):
    """fl [t, 3, 3] of resolved (pos, uv, normal) corner indices (-1 =
    absent) → an expanded TriangleMesh; normals and uvs only where every
    corner of the group has one."""
    pos = positions[fl[..., 0]]                          # [t, 3, 3]
    n = normals[fl[..., 2]] if normals is not None and (fl[..., 2] >= 0).all() \
        else None
    uv = uvs[fl[..., 1]] if uvs is not None and (fl[..., 1] >= 0).all() else None
    t = fl.shape[0]
    return TriangleMesh(
        indices=np.arange(3 * t, dtype=np.int32).reshape(t, 3),
        positions=pos.reshape(-1, 3),
        normals=None if n is None else n.reshape(-1, 3),
        texcoords=None if uv is None else uv.reshape(-1, 2))


def _load_obj_native(path):
    """Through the C++ tokenizer; None when its library is unavailable."""
    from bifrost3d_tpu_torch.io.native_obj import parse_obj_native
    raw = parse_obj_native(path)
    if raw is None:
        return None
    mtl = _parse_mtl(os.path.join(os.path.dirname(path), raw["mtllib"])) \
        if raw["mtllib"] else {}
    ids = raw["tri_material"]
    uniq, first_idx = np.unique(ids, return_index=True)
    order = uniq[np.argsort(first_idx)]
    material_dicts, meshes = [], []
    for mat_idx, mid in enumerate(order):
        name = None if mid < 0 else raw["material_names"][mid]
        material_dicts.append(mtl.get(name, _default_material()))
        fl = raw["tri_corners"][ids == mid].astype(np.int64)
        meshes.append((_assemble_group(raw["positions"], raw["normals"],
                                       raw["uvs"], fl),
                       mat_idx, name or "default"))
    return meshes, material_dicts


def _resolve(i, count):
    """OBJ's 1-based (or negative, from the end) indices → 0-based; 0 (the
    index absent) → -1."""
    return np.where(i > 0, i - 1, np.where(i < 0, count + i, -1))


def load_obj(path, use_native: bool = True):
    """→ (meshes, material_dicts): meshes = [(TriangleMesh, mat_idx, name)]."""
    if use_native:
        result = _load_obj_native(path)
        if result is not None:
            return result
    positions, normals, uvs = [], [], []
    groups = {}  # material name -> list of (pos, uv, normal) corner triples
    cur_mat = None
    mtl = {}

    def corner(token):
        vals = token.split("/")
        vi = int(vals[0])
        ti = int(vals[1]) if len(vals) > 1 and vals[1] else 0
        ni = int(vals[2]) if len(vals) > 2 and vals[2] else 0
        return vi, ti, ni

    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                positions.append([float(p) for p in parts[1:4]])
            elif key == "vn":
                normals.append([float(p) for p in parts[1:4]])
            elif key == "vt":
                uvs.append([float(p) for p in parts[1:3]])
            elif key == "mtllib":
                mtl.update(_parse_mtl(
                    os.path.join(os.path.dirname(path), parts[1])))
            elif key == "usemtl":
                cur_mat = parts[1]
            elif key == "f":
                corners = [corner(t) for t in parts[1:]]
                faces = groups.setdefault(cur_mat, [])
                for k in range(1, len(corners) - 1):  # fan triangulation
                    faces.append((corners[0], corners[k], corners[k + 1]))

    positions = np.asarray(positions, np.float32)
    normals = np.asarray(normals, np.float32) if normals else None
    uvs = np.asarray(uvs, np.float32) if uvs else None
    counts = (len(positions), 0 if uvs is None else len(uvs),
              0 if normals is None else len(normals))

    material_dicts, meshes = [], []
    for mat_idx, (mat_name, faces) in enumerate(groups.items()):
        material_dicts.append(mtl.get(mat_name, _default_material()))
        fl = np.asarray(faces, np.int64)                     # [t, 3, 3]
        fl = np.stack([_resolve(fl[..., k], counts[k]) for k in range(3)],
                      axis=-1)
        meshes.append((_assemble_group(positions, normals, uvs, fl),
                       mat_idx, mat_name or "default"))
    return meshes, material_dicts
