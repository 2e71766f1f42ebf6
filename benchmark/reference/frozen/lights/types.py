"""Light struct-of-arrays and the light-sample record.

Port of ``bifrost3d_tpu/lights/types.py`` (``LightArray``, ``LightSample``,
the ``LIGHT_*`` tags): sphere (position, radius, power), spot (disk
position, radius, direction, cos_angle, power) and directional (direction,
radiance in ``power``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

LIGHT_SPHERE = 0
LIGHT_SPOT = 1
LIGHT_DIRECTIONAL = 2


class LightArray(NamedTuple):
    kind: torch.Tensor       # [l] int32
    position: torch.Tensor   # [l, 3]
    radius: torch.Tensor     # [l]
    power: torch.Tensor      # [l, 3] (radiance for directional)
    direction: torch.Tensor  # [l, 3] (spot/directional)
    cos_angle: torch.Tensor  # [l] (spot cone)

    @property
    def count(self) -> int:
        return int(self.kind.shape[0])

    @staticmethod
    def build(lights, *, device) -> "LightArray":
        """lights: list of dicts with 'kind' and per-type fields."""
        n = len(lights)
        kind = np.zeros(n, np.int32)
        position = np.zeros((n, 3), np.float32)
        radius = np.zeros(n, np.float32)
        power = np.zeros((n, 3), np.float32)
        direction = np.tile(np.asarray([0, 0, 1.0], np.float32), (n, 1))
        cos_angle = np.zeros(n, np.float32)
        for i, li in enumerate(lights):
            kind[i] = li["kind"]
            position[i] = li.get("position", (0, 0, 0))
            radius[i] = li.get("radius", 0.0)
            power[i] = li.get("power", li.get("radiance", (0, 0, 0)))
            d = np.asarray(li.get("direction", (0, 0, 1)), np.float32)
            direction[i] = d / max(np.linalg.norm(d), 1e-20)
            cos_angle[i] = li.get("cos_angle", 0.0)
        return LightArray.from_numpy(dict(
            kind=kind, position=position, radius=radius, power=power,
            direction=direction, cos_angle=cos_angle), device=device)

    @staticmethod
    def from_numpy(arrays: dict, *, device) -> "LightArray":
        """From a dict of this type's field arrays."""
        return LightArray(**{
            f: torch.tensor(np.asarray(arrays[f]), device=device)
            for f in LightArray._fields})


class LightSample(NamedTuple):
    """One next-event-estimation sample toward a light."""

    direction: torch.Tensor  # [..., 3] unit, toward the light
    distance: torch.Tensor   # [...] shadow-ray length
    radiance: torch.Tensor   # [..., 3]
    pdf: torch.Tensor        # [...] solid-angle pdf (lobe prob for deltas)
    is_delta: torch.Tensor   # [...] bool
