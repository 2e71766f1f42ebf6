"""``make_plane``, ``make_box``, ``make_sphere`` and ``transform_mesh`` of
``bifrost3d_tpu_torch/geometry/creation.py`` and ``geometry/mesh.py``,
frozen: host-side numpy, CCW winding, +Y up."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class TriangleMesh(NamedTuple):
    indices: np.ndarray                    # [t, 3] int32
    positions: np.ndarray                  # [v, 3] float32
    normals: Optional[np.ndarray] = None   # [v, 3] float32 (unit)
    texcoords: Optional[np.ndarray] = None  # [v, 2] float32


def _mesh(indices, positions, normals=None, uvs=None) -> TriangleMesh:
    return TriangleMesh(
        indices=np.asarray(indices, np.int32),
        positions=np.asarray(positions, np.float32),
        normals=None if normals is None else np.asarray(normals, np.float32),
        texcoords=None if uvs is None else np.asarray(uvs, np.float32))


def _grid_indices(nx: int, ny: int, flip=False) -> np.ndarray:
    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
    v0 = (j * (nx + 1) + i).ravel()
    v1 = v0 + 1
    v2 = v0 + nx + 1
    v3 = v2 + 1
    tris = np.stack([np.stack([v0, v1, v3], -1), np.stack([v0, v3, v2], -1)], 1)
    tris = tris.reshape(-1, 3)
    if flip:
        tris = tris[:, ::-1]
    return tris.astype(np.int32)


def make_plane(size: float = 1.0, segments: int = 1) -> TriangleMesh:
    n = segments
    u = np.linspace(-0.5, 0.5, n + 1) * size
    xs, zs = np.meshgrid(u, u, indexing="xy")
    pos = np.stack([xs.ravel(), np.zeros((n + 1) ** 2), zs.ravel()], -1)
    normals = np.tile([0.0, 1.0, 0.0], (pos.shape[0], 1))
    uvs = np.stack([xs.ravel() / size + 0.5, zs.ravel() / size + 0.5], -1)
    return _mesh(_grid_indices(n, n, flip=True), pos, normals, uvs)


def make_box(size=1.0, segments: int = 1) -> TriangleMesh:
    size = np.broadcast_to(np.asarray(size, np.float32), (3,)).astype(np.float64)
    n = segments
    eye = np.eye(3)
    faces = []
    for axis in range(3):
        for sgn in (1.0, -1.0):
            normal = eye[axis] * sgn
            tu = eye[(axis + 1) % 3]
            tv = np.cross(normal, tu)
            lin = np.linspace(-0.5, 0.5, n + 1)
            uu, vv = np.meshgrid(lin, lin, indexing="xy")
            pos = (normal * 0.5 + uu.ravel()[:, None] * tu
                   + vv.ravel()[:, None] * tv) * size
            uvs = np.stack([uu.ravel() + 0.5, vv.ravel() + 0.5], -1)
            faces.append((pos, np.tile(normal, ((n + 1) ** 2, 1)), uvs))
    indices, offset = [], 0
    for f in faces:
        indices.append(_grid_indices(n, n) + offset)
        offset += f[0].shape[0]
    return _mesh(np.concatenate(indices),
                 np.concatenate([f[0] for f in faces]),
                 np.concatenate([f[1] for f in faces]),
                 np.concatenate([f[2] for f in faces]))


def make_sphere(radius: float = 0.5, slices: int = 32,
                stacks: int = 16) -> TriangleMesh:
    phi = np.linspace(0, 2 * np.pi, slices + 1)
    theta = np.linspace(0, np.pi, stacks + 1)
    ph, th = np.meshgrid(phi, theta, indexing="xy")
    n = np.stack([np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)], -1)
    pos = (n * radius).reshape(-1, 3)
    uvs = np.stack([ph.ravel() / (2 * np.pi), 1.0 - th.ravel() / np.pi], -1)
    idx = _grid_indices(slices, stacks)
    p = pos[idx]
    area2 = np.linalg.norm(np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]), axis=-1)
    return _mesh(idx[area2 > 1e-12], pos, n.reshape(-1, 3), uvs)


def transform_mesh(mesh: TriangleMesh, matrix3x4) -> TriangleMesh:
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
