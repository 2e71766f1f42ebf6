"""Materials: struct-of-arrays container and factory presets.

Port of the slice's part of ``bifrost3d_tpu/scene/materials.py``
(``MaterialArray`` with ``build`` and ``gather``, ``dielectric``,
``coated_dielectric``, ``metal``, ``emissive``, ``transmissive``, the indices of refraction and their
specularities, the metal tints the scenes use, the ``SHADING_*`` and
``FLAG_*`` constants). Texture slots index the scene's ``TextureBank``
(``-1`` = untextured).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

SHADING_DEFAULT = 0
SHADING_DIFFUSE = 1
SHADING_TRANSMISSIVE = 2

FLAG_THIN_WALLED = 1
FLAG_CUTOUT = 2

# Indices of refraction (Material.h:44-49).
AIR_IOR = 1.0003
ICE_IOR = 1.31
WATER_IOR = 1.33
GLASS_IOR = 1.52
DIAMOND_IOR = 2.42


def _specularity(ior_o, ior_i):
    """Plain-float ``bsdf.fresnel.dielectric_specularity``."""
    return ((ior_o - ior_i) / (ior_o + ior_i)) ** 2


DEFAULT_SPECULARITY = 0.04
ICE_SPECULARITY = _specularity(AIR_IOR, ICE_IOR)
WATER_SPECULARITY = _specularity(AIR_IOR, WATER_IOR)
GLASS_SPECULARITY = _specularity(AIR_IOR, GLASS_IOR)
DIAMOND_SPECULARITY = _specularity(AIR_IOR, DIAMOND_IOR)

# Metal tints (Material.h:62-72, UE4 physically-based materials reference).
IRON_TINT = (0.560, 0.570, 0.580)
SILVER_TINT = (0.972, 0.960, 0.915)
ALUMINUM_TINT = (0.913, 0.921, 0.925)
GOLD_TINT = (1.000, 0.766, 0.336)
COPPER_TINT = (0.955, 0.637, 0.538)
CHROMIUM_TINT = (0.550, 0.556, 0.554)
NICKEL_TINT = (0.660, 0.609, 0.526)
TITANIUM_TINT = (0.542, 0.497, 0.449)
COBALT_TINT = (0.662, 0.655, 0.634)
PLATINUM_TINT = (0.672, 0.637, 0.585)

_INT_FIELDS = ("shading_model", "flags", "tint_roughness_texture",
               "metallic_texture", "coverage_texture")


class MaterialArray(NamedTuple):
    shading_model: torch.Tensor   # [m] int32
    tint: torch.Tensor            # [m, 3]
    roughness: torch.Tensor       # [m]
    specularity: torch.Tensor     # [m]
    metallic: torch.Tensor        # [m]
    coat: torch.Tensor            # [m]
    coat_roughness: torch.Tensor  # [m]
    coverage: torch.Tensor        # [m] (cutout threshold when FLAG_CUTOUT)
    transmission: torch.Tensor    # [m]
    emission: torch.Tensor        # [m, 3]
    flags: torch.Tensor           # [m] int32 bitmask
    tint_roughness_texture: torch.Tensor  # [m] int32 (-1 = none)
    metallic_texture: torch.Tensor        # [m] int32
    coverage_texture: torch.Tensor        # [m] int32

    def gather(self, index) -> "MaterialArray":
        """Every field for per-lane ``index`` (clipped to [0, m-1]) with one
        row gather of the packed [m, 18] table. The JAX version contracts a
        one-hot row on the MXU; both are exact selections."""
        packed = torch.cat([
            self.shading_model.to(torch.float32)[:, None],
            self.tint,
            self.roughness[:, None],
            self.specularity[:, None],
            self.metallic[:, None],
            self.coat[:, None],
            self.coat_roughness[:, None],
            self.coverage[:, None],
            self.transmission[:, None],
            self.emission,
            self.flags.to(torch.float32)[:, None],
            self.tint_roughness_texture.to(torch.float32)[:, None],
            self.metallic_texture.to(torch.float32)[:, None],
            self.coverage_texture.to(torch.float32)[:, None],
        ], dim=1)
        rows = packed[torch.clamp(index.long(), 0, packed.shape[0] - 1)]

        def as_int(col):
            return torch.round(col).to(torch.int32)

        return MaterialArray(
            shading_model=as_int(rows[..., 0]),
            tint=rows[..., 1:4],
            roughness=rows[..., 4],
            specularity=rows[..., 5],
            metallic=rows[..., 6],
            coat=rows[..., 7],
            coat_roughness=rows[..., 8],
            coverage=rows[..., 9],
            transmission=rows[..., 10],
            emission=rows[..., 11:14],
            flags=as_int(rows[..., 14]),
            tint_roughness_texture=as_int(rows[..., 15]),
            metallic_texture=as_int(rows[..., 16]),
            coverage_texture=as_int(rows[..., 17]))

    @staticmethod
    def build(materials, *, device) -> "MaterialArray":
        """materials: list of dicts (see the factory helpers below)."""
        m = len(materials)

        def field(name, default, shape=()):
            arr = np.full((m,) + shape, default, np.float32)
            for i, mat in enumerate(materials):
                if name in mat:
                    arr[i] = mat[name]
            return arr

        def ifield(name, default):
            arr = np.full(m, default, np.int32)
            for i, mat in enumerate(materials):
                if name in mat:
                    arr[i] = mat[name]
            return arr

        for i, mat in enumerate(materials):
            for key, value in mat.items():
                if key != "flags" and not np.all(np.isfinite(
                        np.asarray(value, np.float64))):
                    raise ValueError(
                        f"material {i} field {key!r} is not finite: {value}")

        return MaterialArray.from_numpy(dict(
            shading_model=ifield("shading_model", SHADING_DEFAULT),
            tint=field("tint", 1.0, (3,)),
            roughness=field("roughness", 0.5),
            specularity=field("specularity", DEFAULT_SPECULARITY),
            metallic=field("metallic", 0.0),
            coat=field("coat", 0.0),
            coat_roughness=field("coat_roughness", 0.0),
            coverage=field("coverage", 1.0),
            transmission=field("transmission", 0.0),
            emission=field("emission", 0.0, (3,)),
            flags=ifield("flags", 0),
            tint_roughness_texture=ifield("tint_roughness_texture", -1),
            metallic_texture=ifield("metallic_texture", -1),
            coverage_texture=ifield("coverage_texture", -1)), device=device)

    @staticmethod
    def from_numpy(arrays: dict, *, device) -> "MaterialArray":
        """From a dict of this type's field arrays."""
        out = {}
        for f in MaterialArray._fields:
            dtype = np.int32 if f in _INT_FIELDS else np.float32
            out[f] = torch.tensor(np.asarray(arrays[f], dtype), device=device)
        return MaterialArray(**out)


def dielectric(tint, roughness, specularity=DEFAULT_SPECULARITY, **kw):
    return dict(tint=tint, roughness=roughness, specularity=specularity, **kw)


def coated_dielectric(tint, roughness, specularity=DEFAULT_SPECULARITY,
                      coat_roughness=0.0, **kw):
    return dict(tint=tint, roughness=roughness, specularity=specularity,
                coat=1.0, coat_roughness=coat_roughness, **kw)


def transmissive(tint, roughness, specularity=GLASS_SPECULARITY, **kw):
    return dict(shading_model=SHADING_TRANSMISSIVE, tint=tint,
                roughness=roughness, specularity=specularity, **kw)


def metal(tint, roughness, **kw):
    return dict(tint=tint, roughness=roughness, specularity=1.0, metallic=1.0,
                **kw)


def emissive(radiance, **kw):
    return dict(tint=(0, 0, 0), emission=radiance, **kw)
