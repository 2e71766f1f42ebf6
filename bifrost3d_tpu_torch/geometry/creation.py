"""Procedural meshes: plane, box, UV sphere, cylinder, beveled box, quad
sphere and torus (CCW winding, +Y up).

Port of ``bifrost3d_tpu/geometry/creation.py`` (``make_plane``,
``make_box``, ``make_sphere``, ``make_cylinder``, ``make_beveled_box``,
``make_spherical_box``, ``make_torus``), host-side numpy.
"""

from __future__ import annotations

import numpy as np

from bifrost3d_tpu_torch.geometry.mesh import (
    TriangleMesh,
    merge_duplicate_vertices,
)


def _mesh(indices, positions, normals=None, uvs=None) -> TriangleMesh:
    return TriangleMesh(
        indices=np.asarray(indices, np.int32),
        positions=np.asarray(positions, np.float32),
        normals=None if normals is None else np.asarray(normals, np.float32),
        texcoords=None if uvs is None else np.asarray(uvs, np.float32))


def _grid_indices(nx: int, ny: int, flip=False) -> np.ndarray:
    """Triangulate an (nx+1)x(ny+1) vertex grid, CCW from +(u x v)."""
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
    """XZ plane centred at the origin, +Y normal."""
    n = segments
    u = np.linspace(-0.5, 0.5, n + 1) * size
    xs, zs = np.meshgrid(u, u, indexing="xy")
    pos = np.stack([xs.ravel(), np.zeros((n + 1) ** 2), zs.ravel()], -1)
    normals = np.tile([0.0, 1.0, 0.0], (pos.shape[0], 1))
    uvs = np.stack([xs.ravel() / size + 0.5, zs.ravel() / size + 0.5], -1)
    return _mesh(_grid_indices(n, n, flip=True), pos, normals, uvs)


def make_box(size=1.0, segments: int = 1) -> TriangleMesh:
    """Axis-aligned box centred at the origin with per-face normals; each
    face's (tu, tv) frame has ``cross(tu, tv)`` = the outward normal."""
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
    """UV (revolved) sphere without the collapsed pole triangles."""
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


def make_cylinder(radius: float = 0.5, height: float = 1.0,
                  slices: int = 32, stacks: int = 1) -> TriangleMesh:
    """Capped cylinder along +Y."""
    phi = np.linspace(0, 2 * np.pi, slices + 1)
    ys = np.linspace(-0.5, 0.5, stacks + 1) * height
    ph, yy = np.meshgrid(phi, ys, indexing="xy")
    side_pos = np.stack([radius * np.cos(ph), yy, radius * np.sin(ph)],
                        -1).reshape(-1, 3)
    side_n = np.stack([np.cos(ph), np.zeros_like(ph), np.sin(ph)],
                      -1).reshape(-1, 3)
    side_uv = np.stack([ph.ravel() / (2 * np.pi), yy.ravel() / height + 0.5],
                       -1)
    parts = [(_grid_indices(slices, stacks, flip=True), side_pos, side_n,
              side_uv)]
    offset = side_pos.shape[0]
    for sign in (1.0, -1.0):
        center = np.asarray([[0.0, 0.5 * height * sign, 0.0]])
        ring = np.stack([radius * np.cos(phi),
                         np.full_like(phi, 0.5 * height * sign),
                         radius * np.sin(phi)], -1)
        pos = np.concatenate([center, ring])
        nrm = np.tile([0.0, sign, 0.0], (pos.shape[0], 1))
        uv = np.concatenate([[[0.5, 0.5]], np.stack(
            [np.cos(phi), np.sin(phi)], -1) * 0.5 + 0.5])
        k = np.arange(slices)
        tri = np.stack([np.zeros_like(k), k + 1, k + 2], -1)
        # The fan (c, ring_k, ring_k+1) winds -y; flip it for the top cap.
        if sign > 0:
            tri = tri[:, ::-1]
        parts.append((tri + offset, pos, nrm, uv))
        offset += pos.shape[0]
    return _mesh(*(np.concatenate([p[i] for p in parts]) for i in range(4)))


def make_beveled_box(size=1.0, bevel: float = 0.1,
                     segments: int = 4) -> TriangleMesh:
    """Box with rounded edges (MeshCreation::beveled_box): a tessellated
    box whose vertices snap to ``core + b·normalize(p - core)``, ``core``
    the point clamped to ±(half - b), ``b`` = ``bevel`` (in [0, 1]) × half
    the smallest extent; normals are the snap directions, so faces stay
    flat and edges and corners round."""
    size = np.broadcast_to(np.asarray(size, np.float64), (3,))
    half = size * 0.5
    b = float(np.clip(bevel, 0.0, 1.0)) * float(half.min())
    base = make_box(size=size, segments=max(2 * segments, 2))
    pos = np.asarray(base.positions, np.float64)
    inner = np.maximum(half - b, 0.0)
    core = np.clip(pos, -inner, inner)
    d = pos - core
    dist = np.linalg.norm(d, axis=-1, keepdims=True)
    n = np.where(dist > 1e-12, d / np.maximum(dist, 1e-12),
                 np.asarray(base.normals, np.float64))
    return merge_duplicate_vertices(
        _mesh(base.indices, core + n * b, n, base.texcoords), tolerance=1e-6)


def make_spherical_box(radius: float = 0.5,
                       segments: int = 8) -> TriangleMesh:
    """Quad sphere: a tessellated cube projected onto the sphere
    (MeshCreation::spherical_box), without the UV sphere's pole pinch."""
    base = make_box(size=1.0, segments=segments)
    pos = np.asarray(base.positions, np.float64)
    n = pos / np.linalg.norm(pos, axis=-1, keepdims=True)
    return merge_duplicate_vertices(
        _mesh(base.indices, n * radius, n, base.texcoords), tolerance=1e-6)


def make_torus(major_radius: float = 1.0, minor_radius: float = 0.25,
               major_segments: int = 32,
               minor_segments: int = 16) -> TriangleMesh:
    u = np.linspace(0, 2 * np.pi, major_segments + 1)
    v = np.linspace(0, 2 * np.pi, minor_segments + 1)
    uu, vv = np.meshgrid(u, v, indexing="xy")
    cx = np.stack([np.cos(uu), np.zeros_like(uu), np.sin(uu)], -1)
    n = (cx * np.cos(vv)[..., None]
         + np.stack([np.zeros_like(uu), np.ones_like(uu), np.zeros_like(uu)], -1)
         * np.sin(vv)[..., None])
    pos = (cx * major_radius + n * minor_radius).reshape(-1, 3)
    uvs = np.stack([uu.ravel() / (2 * np.pi), vv.ravel() / (2 * np.pi)], -1)
    return _mesh(_grid_indices(major_segments, minor_segments, flip=True), pos,
                 n.reshape(-1, 3), uvs)
