"""Triangle meshes (host side).

Port of the slice's part of ``bifrost3d_tpu/geometry/mesh.py``
(``TriangleMesh``, ``mesh_aabb``, ``compute_smooth_normals``,
``transform_mesh``, ``combine_meshes``). Meshes
are assets built once on the host, so their buffers are numpy arrays;
``scene.render_scene.build_render_scene`` flattens them into device
tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class TriangleMesh(NamedTuple):
    indices: np.ndarray                          # [t, 3] int32
    positions: np.ndarray                        # [v, 3] float32
    normals: Optional[np.ndarray] = None         # [v, 3] float32 (unit)
    texcoords: Optional[np.ndarray] = None       # [v, 2] float32
    tint_roughness: Optional[np.ndarray] = None  # [v, 4] float32


def mesh_aabb(mesh: TriangleMesh):
    """(min, max) corner arrays — Mesh::compute_bounds."""
    pos = np.asarray(mesh.positions)
    return pos.min(axis=0), pos.max(axis=0)


def compute_smooth_normals(mesh: TriangleMesh) -> TriangleMesh:
    """Area-weighted vertex normals (MeshUtils::compute_normals)."""
    idx = np.asarray(mesh.indices)
    pos = np.asarray(mesh.positions)
    face_n = np.cross(pos[idx[:, 1]] - pos[idx[:, 0]],
                      pos[idx[:, 2]] - pos[idx[:, 0]])
    normals = np.zeros_like(pos)
    for k in range(3):
        np.add.at(normals, idx[:, k], face_n)
    normals /= np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-20)
    return mesh._replace(normals=normals.astype(np.float32))


def transform_mesh(mesh: TriangleMesh, matrix3x4) -> TriangleMesh:
    """Affine transform of positions (normals by the inverse transpose)."""
    m = np.asarray(matrix3x4, np.float32)
    rot, trans = m[:, :3], m[:, 3]
    pos = np.asarray(mesh.positions) @ rot.T + trans
    out = mesh._replace(positions=pos.astype(np.float32))
    if mesh.normals is not None:
        inv_t = np.linalg.inv(rot).T
        n = np.asarray(mesh.normals) @ inv_t.T
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
        out = out._replace(normals=n.astype(np.float32))
    return out


def combine_meshes(meshes) -> TriangleMesh:
    """Concatenate N meshes into one (MeshUtils::combine). Optional buffers
    present in any input get defaults in the rest."""
    any_normals = any(m.normals is not None for m in meshes)
    any_uv = any(m.texcoords is not None for m in meshes)
    any_tr = any(m.tint_roughness is not None for m in meshes)

    indices, positions, normals, uvs, trs = [], [], [], [], []
    offset = 0
    for m in meshes:
        v = m.positions.shape[0]
        indices.append(np.asarray(m.indices) + offset)
        positions.append(np.asarray(m.positions))
        if any_normals:
            normals.append(np.asarray(m.normals) if m.normals is not None
                           else np.tile([0, 0, 1.0], (v, 1)))
        if any_uv:
            uvs.append(np.asarray(m.texcoords) if m.texcoords is not None
                       else np.zeros((v, 2)))
        if any_tr:
            trs.append(np.asarray(m.tint_roughness)
                       if m.tint_roughness is not None
                       else np.tile([1, 1, 1, 1.0], (v, 1)))
        offset += v

    def cat(parts, dtype=np.float32):
        return np.concatenate(parts).astype(dtype)

    return TriangleMesh(
        indices=cat(indices, np.int32),
        positions=cat(positions),
        normals=cat(normals) if any_normals else None,
        texcoords=cat(uvs) if any_uv else None,
        tint_roughness=cat(trs) if any_tr else None)
