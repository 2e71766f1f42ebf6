"""Pixel-format-aware image asset: formats, 2D/3D sizes, mips, SAT.

Port of ``bifrost3d_tpu/io/pixel_image.py`` (``PixelImage``,
``channel_count``, ``is_byte_format`` and the ``PixelFormat`` constants),
the counterpart of the reference's ``Assets/Image.h:27-120`` /
``Image.cpp``: a storage-format-tagged image with an sRGB/linear gamma
flag, a mipmap chain, ``get/set_pixel``, ``change_format`` and a
summed-area table. Host-side numpy, as the JAX package's: pixel storage is
an array on the host, conversions are vectorised, and device code takes
float arrays through ``to_float()`` and the TextureBank.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from bifrost3d_tpu_torch.io.texture import (
    fill_mipmaps as _fill_mip_chain,
    summed_area_table,
)

# PixelFormat (Assets/Image.h:27-37).
UNKNOWN = 0
ALPHA8 = 1          # 1 x UNorm8
INTENSITY8 = 2      # 1 x UNorm8
RGB24 = 3           # 3 x UNorm8
RGBA32 = 4          # 4 x UNorm8
INTENSITY_FLOAT = 5
RGB_FLOAT = 6
RGBA_FLOAT = 7

_CHANNELS = {ALPHA8: 1, INTENSITY8: 1, RGB24: 3, RGBA32: 4,
             INTENSITY_FLOAT: 1, RGB_FLOAT: 3, RGBA_FLOAT: 4}
_IS_BYTE = {ALPHA8: True, INTENSITY8: True, RGB24: True, RGBA32: True,
            INTENSITY_FLOAT: False, RGB_FLOAT: False, RGBA_FLOAT: False}


def channel_count(fmt: int) -> int:
    return _CHANNELS[fmt]


def is_byte_format(fmt: int) -> bool:
    return _IS_BYTE[fmt]


class PixelImage:
    """Format-tagged image with 3D size and a mipmap chain.

    ``data`` is stored as [depth, height, width, channels]; byte formats
    as uint8, float formats as float32. 2D images have depth 1 (the
    reference packs 2D/3D the same way, Image.h:59-66).
    """

    def __init__(self, fmt: int, size: Tuple[int, int, int] | Tuple[int, int],
                 gamma: float = 1.0, data: Optional[np.ndarray] = None,
                 mipmap_count: int = 1):
        if len(size) == 2:
            size = (size[0], size[1], 1)
        self.format = int(fmt)
        self.width, self.height, self.depth = (int(s) for s in size)
        self.gamma = float(gamma)  # 2.2 flags sRGB-encoded storage
        c = channel_count(fmt)
        dtype = np.uint8 if is_byte_format(fmt) else np.float32
        if data is None:
            data = np.zeros((self.depth, self.height, self.width, c), dtype)
        else:
            data = np.asarray(data, dtype)
            if data.ndim == 2:
                data = data[None, ..., None]
            elif data.ndim == 3:
                data = data[None]
            assert data.shape == (self.depth, self.height, self.width, c), \
                (data.shape, (self.depth, self.height, self.width, c))
        self.data = data
        self._mips: List[np.ndarray] = [data]
        if mipmap_count > 1:
            self.fill_mipmaps(mipmap_count)

    # -- size & mips --------------------------------------------------------

    @property
    def size(self) -> Tuple[int, int, int]:
        return (self.width, self.height, self.depth)

    @property
    def is_3d(self) -> bool:
        return self.depth > 1

    @property
    def mipmap_count(self) -> int:
        return len(self._mips)

    def mip(self, level: int) -> np.ndarray:
        return self._mips[level]

    def fill_mipmaps(self, count: Optional[int] = None) -> None:
        """Box-filter mip chain down to 1x1 (Image.cpp fill_mipmaps).
        3D images mip in x/y only (matching the reference's 2D chain)."""
        chain = [_fill_mip_chain(self.to_float()[z])
                 for z in range(self.depth)]
        levels = len(chain[0]) if count is None else min(count, len(chain[0]))
        self._mips = [self.data]
        for level in range(1, levels):
            planes = np.stack([chain[z][level] for z in range(self.depth)])
            self._mips.append(self._from_float(planes))

    # -- pixels -------------------------------------------------------------

    def get_pixel(self, x: int, y: int, z: int = 0,
                  mip: int = 0) -> np.ndarray:
        """→ float RGBA (missing channels fill as the reference does:
        alpha-only → (0,0,0,a), intensity → (i,i,i,1), rgb → a=1)."""
        m = self._mips[mip]
        raw = m[z, y, x].astype(np.float32)
        if is_byte_format(self.format):
            raw = raw / 255.0
        return self._expand_rgba(raw)

    def set_pixel(self, value, x: int, y: int, z: int = 0,
                  mip: int = 0) -> None:
        value = np.asarray(value, np.float32).reshape(-1)
        c = channel_count(self.format)
        if self.format == ALPHA8:
            raw = value[3:4] if value.size == 4 else value[:1]
        elif self.format in (INTENSITY8, INTENSITY_FLOAT):
            raw = value[:1] if value.size < 3 else \
                np.mean(value[:3], keepdims=True)
        else:
            raw = np.concatenate([value, np.ones(4)])[:c]
        if is_byte_format(self.format):
            raw = np.clip(raw * 255.0 + 0.5, 0, 255).astype(np.uint8)
        self._mips[mip][z, y, x] = raw

    def _expand_rgba(self, raw: np.ndarray) -> np.ndarray:
        if self.format == ALPHA8:
            return np.asarray([0.0, 0.0, 0.0, raw[0]], np.float32)
        if self.format in (INTENSITY8, INTENSITY_FLOAT):
            i = raw[0]
            return np.asarray([i, i, i, 1.0], np.float32)
        if raw.shape[-1] == 3:
            return np.concatenate([raw, [1.0]]).astype(np.float32)
        return raw.astype(np.float32)

    # -- conversions --------------------------------------------------------

    def to_float(self) -> np.ndarray:
        """[depth, h, w, c] float32 in [0,1]-ish linear storage units."""
        if is_byte_format(self.format):
            return self.data.astype(np.float32) / 255.0
        return self.data.astype(np.float32)

    def _from_float(self, f: np.ndarray) -> np.ndarray:
        if is_byte_format(self.format):
            return (np.clip(f, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        return np.asarray(f, np.float32)

    def change_format(self, new_fmt: int,
                      new_gamma: Optional[float] = None) -> "PixelImage":
        """→ a new image in ``new_fmt`` (Image.cpp change_format): RGBA
        expansion per ``get_pixel`` rules, gamma re-encode when the
        source/target gamma differ."""
        new_gamma = self.gamma if new_gamma is None else float(new_gamma)
        f = self.to_float()               # [d, h, w, c] storage units
        # Expand to RGBA.
        if self.format == ALPHA8:
            rgba = np.concatenate([np.zeros_like(f).repeat(3, -1), f], -1)
        elif self.format in (INTENSITY8, INTENSITY_FLOAT):
            rgba = np.concatenate([f, f, f, np.ones_like(f)], -1)
        elif f.shape[-1] == 3:
            rgba = np.concatenate([f, np.ones_like(f[..., :1])], -1)
        else:
            rgba = f
        if new_gamma != self.gamma:
            rgb = np.clip(rgba[..., :3], 0.0, None)
            rgba = np.concatenate(
                [rgb ** (self.gamma / new_gamma), rgba[..., 3:]], -1)
        # Collapse to the target layout.
        if new_fmt == ALPHA8:
            out = rgba[..., 3:]
        elif new_fmt in (INTENSITY8, INTENSITY_FLOAT):
            out = np.mean(rgba[..., :3], axis=-1, keepdims=True)
        else:
            out = rgba[..., :channel_count(new_fmt)]
        img = PixelImage(new_fmt, self.size, gamma=new_gamma)
        img.data = img._from_float(out)
        img._mips = [img.data]
        return img

    # -- derived ------------------------------------------------------------

    def summed_area_table(self) -> np.ndarray:
        """[h, w, c] inclusive 2D prefix sums of mip 0 (2D images)."""
        assert not self.is_3d
        return summed_area_table(self.to_float()[0])
