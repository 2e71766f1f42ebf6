"""Triangle meshes (host side).

Port of ``bifrost3d_tpu/geometry/mesh.py`` (``TriangleMesh``,
``mesh_aabb``, ``compute_hard_normals``, ``compute_smooth_normals``,
``transform_mesh``, ``combine_meshes``, ``expand_indexed_buffers``,
``merge_duplicate_vertices``, ``normals_correspond_to_winding_order``,
``count_degenerate_primitives``). The per-vertex ``emission`` buffer
rides through the mesh utilities and no renderer reads it, as in JAX.
Meshes are assets built once on the host, so their buffers are numpy
arrays;
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
    emission: Optional[np.ndarray] = None        # [v, 3] float32


def mesh_aabb(mesh: TriangleMesh):
    """(min, max) corner arrays — Mesh::compute_bounds."""
    pos = np.asarray(mesh.positions)
    return pos.min(axis=0), pos.max(axis=0)


def compute_hard_normals(mesh: TriangleMesh) -> TriangleMesh:
    """Flat-shaded normals: every triangle owns its three vertices, whose
    normal is the face's (MeshUtils::compute_hard_normals)."""
    m = expand_indexed_buffers(mesh)
    p = np.asarray(m.positions).reshape(-1, 3, 3)
    n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    return m._replace(normals=np.repeat(n, 3, axis=0).astype(np.float32))


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
    any_em = any(m.emission is not None for m in meshes)

    indices, positions, normals, uvs, trs, ems = [], [], [], [], [], []
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
        if any_em:
            ems.append(np.asarray(m.emission) if m.emission is not None
                       else np.zeros((v, 3)))
        offset += v

    def cat(parts, dtype=np.float32):
        return np.concatenate(parts).astype(dtype)

    return TriangleMesh(
        indices=cat(indices, np.int32),
        positions=cat(positions),
        normals=cat(normals) if any_normals else None,
        texcoords=cat(uvs) if any_uv else None,
        tint_roughness=cat(trs) if any_tr else None,
        emission=cat(ems) if any_em else None)


def _attributes(mesh: TriangleMesh) -> tuple:
    return (mesh.normals, mesh.texcoords, mesh.tint_roughness, mesh.emission)


def expand_indexed_buffers(mesh: TriangleMesh) -> TriangleMesh:
    """Un-index: vertex i of triangle t becomes vertex 3t+i
    (MeshUtils::expand_indexed_buffer)."""
    idx = np.asarray(mesh.indices).reshape(-1)
    return TriangleMesh(
        np.arange(idx.size, dtype=np.int32).reshape(-1, 3),
        np.asarray(mesh.positions)[idx],
        *(None if b is None else np.asarray(b)[idx]
          for b in _attributes(mesh)))


def merge_duplicate_vertices(mesh: TriangleMesh,
                             tolerance: float = 0.0) -> TriangleMesh:
    """Weld vertices whose every present attribute matches, exactly at
    tolerance 0 and after quantization by ``tolerance`` otherwise
    (MeshUtils::merge_duplicate_vertices); the first occurrences keep
    their order."""
    parts = [np.asarray(mesh.positions)] + [
        np.asarray(b) for b in _attributes(mesh) if b is not None]
    key = np.concatenate(parts, axis=-1)
    if tolerance > 0:
        key = np.round(key / tolerance)
    _, first, inverse = np.unique(key, axis=0, return_index=True,
                                  return_inverse=True)
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    remap = rank[inverse.reshape(-1)]
    keep = first[order]
    return TriangleMesh(
        remap[np.asarray(mesh.indices)].astype(np.int32),
        np.asarray(mesh.positions)[keep],
        *(None if b is None else np.asarray(b)[keep]
          for b in _attributes(mesh)))


def _face_normals(mesh: TriangleMesh) -> np.ndarray:
    idx = np.asarray(mesh.indices)
    pos = np.asarray(mesh.positions)
    return np.cross(pos[idx[:, 1]] - pos[idx[:, 0]],
                    pos[idx[:, 2]] - pos[idx[:, 0]])


def normals_correspond_to_winding_order(mesh: TriangleMesh) -> bool:
    """True if the vertex normals mostly agree with the CCW face normals."""
    idx = np.asarray(mesh.indices)
    n = np.asarray(mesh.normals)
    face_n = _face_normals(mesh)
    agree = 0.0
    for k in range(3):
        agree += np.sum(np.sum(face_n * n[idx[:, k]], axis=-1) > 0)
    return bool(agree >= 0.5 * 3 * idx.shape[0])


def count_degenerate_primitives(mesh: TriangleMesh,
                                epsilon: float = 1e-10) -> int:
    """Triangles with (near-)zero area or a repeated index."""
    idx = np.asarray(mesh.indices)
    area2 = np.linalg.norm(_face_normals(mesh), axis=-1)
    repeated = ((idx[:, 0] == idx[:, 1]) | (idx[:, 1] == idx[:, 2])
                | (idx[:, 0] == idx[:, 2]))
    return int(np.sum((area2 <= epsilon) | repeated))
