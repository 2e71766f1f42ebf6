"""The device mesh of a sharded render, and the placements over it.

Port of ``bifrost3d_tpu/parallel/mesh.py``. JAX lays a 1-D ``Mesh`` with
one ``'tiles'`` axis over its devices and shards with ``NamedSharding``.
Here one process drives the mesh: a mesh is the ordered list of torch
devices along ``'tiles'``, shard i living on ``mesh[i]``. A mesh may name
one device more than once (``[cuda:0] * 4``, ``[cpu] * 8``): the shards are
then rendered one after another on that device, with the same row split
and reductions as on as many devices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

TILE_AXIS = "tiles"


def render_mesh(devices=None) -> list:
    """The 1-D ``'tiles'`` mesh over the given devices, or over every CUDA
    card of this process when none are given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "render_mesh: no CUDA card; pass devices=[torch.device('cpu')]"
                " (or a list of them) to shard on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh = [torch.device(d) for d in devices]
    if not mesh:
        raise ValueError("render_mesh: a mesh needs at least one device")
    return mesh


class Sharding(NamedTuple):
    """Where a tensor's blocks live: along the leading axis over the mesh
    (``tiles``) or a whole copy on every device (replicated)."""

    mesh: list
    tiles: bool

    def place(self, x: torch.Tensor) -> list:
        """``x`` as one tensor per device of the mesh: its leading axis cut
        into equal row blocks (tiled) or the whole of it (replicated)."""
        if not self.tiles:
            return [x.to(d) for d in self.mesh]
        n = len(self.mesh)
        if x.shape[0] % n:
            raise ValueError(f"leading axis {x.shape[0]} does not divide "
                             f"over a mesh of {n} devices")
        return [block.to(d) for block, d in zip(x.chunk(n), self.mesh)]


def tile_sharding(mesh) -> Sharding:
    """Shard the leading (row / tile) axis across the mesh."""
    return Sharding(list(mesh), True)


def replicated_sharding(mesh) -> Sharding:
    return Sharding(list(mesh), False)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
