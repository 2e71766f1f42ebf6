"""Triangle meshes (host side).

Port of the slice's part of ``bifrost3d_tpu/geometry/mesh.py``
(``TriangleMesh``, ``compute_smooth_normals``, ``transform_mesh``). Meshes
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
