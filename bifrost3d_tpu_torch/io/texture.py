"""Textures: mipmaps, samplers and the TextureBank.

Port of ``bifrost3d_tpu/io/texture.py`` (``fill_mipmaps``,
``summed_area_table``, ``sat_region_average``, ``TextureBank``
with ``build``, ``count`` and ``has_trilinear``, ``_wrap_coord``,
``_sample_level``, ``sample_texture``, the ``FILTER_*`` / ``WRAP_*``
constants, the unorm helpers), the counterpart of the reference's
``Assets/Image.h`` + ``Assets/Texture.h``: mipmap chains and sampler state
(filter None/Linear/Trilinear, wrap Clamp/Repeat).

All textures of a scene live in one padded atlas [n, atlas_h, max_w, 4]
(the :class:`TextureBank`), so a per-lane fetch is one gather indexed by
(texture id, y, x). :func:`sample_texture` fetches level 0 with NEAREST or
bilinear filtering, or, asked for trilinear minification with a ray
footprint, blends the two mip levels around the footprint's level of
detail. The mip chain is packed as in the JAX package, so that the atlas is
the same array.

``jnp.mod`` is a floor-mod and ``jnp.round`` rounds half to even:
``torch.remainder`` and ``torch.round`` do the same.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from bifrost3d_tpu_torch.math.clip import maximum

# Filter modes (Assets/Texture.h sampler state).
FILTER_NONE = 0
FILTER_LINEAR = 1
FILTER_TRILINEAR = 2

WRAP_CLAMP = 0
WRAP_REPEAT = 1

MAX_MIP_LEVELS = 16


def fill_mipmaps(image: np.ndarray) -> List[np.ndarray]:
    """Full mip chain by 2x2 box down-filtering (Image::fill_mipmaps)."""
    mips = [np.asarray(image, np.float32)]
    while min(mips[-1].shape[0], mips[-1].shape[1]) > 1:
        prev = mips[-1]
        h2, w2 = max(prev.shape[0] // 2, 1), max(prev.shape[1] // 2, 1)
        p = prev[:h2 * 2, :w2 * 2]
        mips.append(0.25 * (p[0::2, 0::2] + p[1::2, 0::2]
                            + p[0::2, 1::2] + p[1::2, 1::2]))
    return mips


def summed_area_table(image: np.ndarray) -> np.ndarray:
    """Inclusive 2D prefix sum (Image summed-area table), in float64."""
    return np.cumsum(np.cumsum(np.asarray(image, np.float64), axis=0), axis=1)


def sat_region_average(sat: np.ndarray, x0: int, y0: int, x1: int, y1: int):
    """Mean over the inclusive pixel region [x0, x1] × [y0, y1]."""
    total = sat[y1, x1].copy()
    if x0 > 0:
        total -= sat[y1, x0 - 1]
    if y0 > 0:
        total -= sat[y0 - 1, x1]
    if x0 > 0 and y0 > 0:
        total += sat[y0 - 1, x0 - 1]
    return total / ((x1 - x0 + 1) * (y1 - y0 + 1))


_INT_FIELDS = ("sizes", "filters", "wraps", "mip_offsets", "mip_sizes",
               "n_levels")


class TextureBank(NamedTuple):
    """All scene textures in one padded array + per-texture metadata.

    The full mip chain of every texture is packed vertically into the atlas
    (level l of texture i starts at row ``mip_offsets[i, l]`` with size
    ``mip_sizes[i, l]``).
    """

    data: torch.Tensor         # [n, atlas_h, max_w, 4] float32 (linear)
    sizes: torch.Tensor        # [n, 2] int32 (h, w) of level 0
    filters: torch.Tensor      # [n] int32 (FILTER_*)
    wraps: torch.Tensor        # [n, 2] int32 (wrap_u, wrap_v)
    mip_offsets: torch.Tensor  # [n, MAX_MIP_LEVELS] int32 row offset / level
    mip_sizes: torch.Tensor    # [n, MAX_MIP_LEVELS, 2] int32 (h, w) / level
    n_levels: torch.Tensor     # [n] int32

    @property
    def count(self) -> int:
        return int(self.data.shape[0]) if self.data.dim() == 4 else 0

    def has_trilinear(self) -> bool:
        """Host-side hint for ``settings_for_scene``."""
        return self.count > 0 and bool(
            torch.any(self.filters == FILTER_TRILINEAR))

    @staticmethod
    def from_numpy(arrays: dict, *, device) -> "TextureBank":
        """From a dict of this type's field arrays."""
        return TextureBank(**{
            f: torch.tensor(np.asarray(
                arrays[f], np.int32 if f in _INT_FIELDS else np.float32),
                device=device)
            for f in TextureBank._fields})

    @staticmethod
    def build(textures, *, device) -> "TextureBank":
        """textures: list of dicts {image [h,w,c] float, filter, wrap_u,
        wrap_v}; an empty list gives a bank of no texture, which
        ``sample_texture`` answers with its default without a gather."""
        L = MAX_MIP_LEVELS
        n = len(textures)
        if not textures:
            return TextureBank.from_numpy(dict(
                data=np.zeros((0, 1, 1, 4)), sizes=np.ones((0, 2)),
                filters=np.zeros(0), wraps=np.ones((0, 2)),
                mip_offsets=np.zeros((0, L)), mip_sizes=np.ones((0, L, 2)),
                n_levels=np.ones(0)), device=device)
        chains = []
        for t in textures:
            img = np.asarray(t["image"], np.float32)
            if img.ndim == 2:
                img = img[..., None]
            chains.append(fill_mipmaps(img)[:L])
        max_w = max(c[0].shape[1] for c in chains)
        atlas_h = max(sum(m.shape[0] for m in c) for c in chains)
        data = np.zeros((n, atlas_h, max_w, 4), np.float32)
        sizes = np.zeros((n, 2), np.int32)
        filters = np.zeros(n, np.int32)
        wraps = np.zeros((n, 2), np.int32)
        mip_offsets = np.zeros((n, L), np.int32)
        mip_sizes = np.ones((n, L, 2), np.int32)
        n_levels = np.zeros(n, np.int32)
        for i, (t, chain) in enumerate(zip(textures, chains)):
            oy = 0
            for li, m in enumerate(chain):
                h, w, c = m.shape[0], m.shape[1], m.shape[-1]
                data[i, oy:oy + h, :w, :c] = m
                if c < 4:
                    data[i, oy:oy + h, :w, 3] = 1.0
                mip_offsets[i, li] = oy
                mip_sizes[i, li] = (h, w)
                oy += h
            # Degenerate levels clamp to the last real one.
            for li in range(len(chain), L):
                mip_offsets[i, li] = mip_offsets[i, len(chain) - 1]
                mip_sizes[i, li] = mip_sizes[i, len(chain) - 1]
            n_levels[i] = len(chain)
            sizes[i] = (chain[0].shape[0], chain[0].shape[1])
            filters[i] = t.get("filter", FILTER_LINEAR)
            wraps[i] = (t.get("wrap_u", WRAP_REPEAT),
                        t.get("wrap_v", WRAP_REPEAT))
        return TextureBank.from_numpy(dict(
            data=data, sizes=sizes, filters=filters, wraps=wraps,
            mip_offsets=mip_offsets, mip_sizes=mip_sizes, n_levels=n_levels),
            device=device)


def _wrap_coord(i, n, mode):
    clamped = torch.minimum(torch.clamp_min(i, 0), n - 1)
    repeated = torch.remainder(i, torch.clamp_min(n, 1))
    return torch.where(mode == WRAP_REPEAT, repeated, clamped)


def _sample_level(bank: TextureBank, tid, fu, fv, wrap_u, wrap_v, filt,
                  level):
    """Nearest/bilinear fetch of one mip level (Texture.cpp sample2D with
    an explicit mipmap_level): coordinates scale to the level's size and
    rows shift by the level's atlas offset."""
    h = bank.mip_sizes[tid, level, 0].long()
    w = bank.mip_sizes[tid, level, 1].long()
    oy = bank.mip_offsets[tid, level].long()

    x = fu * w - 0.5
    y = fv * h - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    tx = (x - x0f)[..., None]
    ty = (y - y0f)[..., None]
    x0 = x0f.long()
    y0 = y0f.long()

    def fetch(xi, yi):
        xi = _wrap_coord(xi, w, wrap_u)
        yi = _wrap_coord(yi, h, wrap_v)
        return bank.data[tid, oy + yi, xi]

    nearest = fetch(torch.round(x).long(), torch.round(y).long())
    bilinear = ((fetch(x0, y0) * (1 - tx) + fetch(x0 + 1, y0) * tx) * (1 - ty)
                + (fetch(x0, y0 + 1) * (1 - tx)
                   + fetch(x0 + 1, y0 + 1) * tx) * ty)
    return torch.where((filt == FILTER_NONE)[..., None], nearest, bilinear)


def sample_texture(bank, texture_id, uv, default=None, footprint_uv=None,
                   trilinear: bool = False):
    """Per-lane texture fetch: texture_id [...] int (-1 = use default),
    uv [..., 2] → rgba [..., 4].

    Nearest or bilinear per the texture's sampler state (Texture::sample2D);
    v = 0 is the bottom of the image (the reference's texcoord convention).
    Trilinear minification (Texture.h MinificationFilter::Trilinear): with
    ``trilinear`` set and ``footprint_uv`` the ray footprint in uv units,
    a ``FILTER_TRILINEAR`` texture blends the two mip levels around lod =
    log2(max(footprint · size, 1)); other textures stay on level 0. A bank
    of no texture (or ``None``) answers with the default and gathers
    nothing.
    """
    device = uv.device
    if default is None:
        default = torch.ones(4, dtype=torch.float32, device=device)
    if bank is None or bank.count == 0:
        return default.expand(tuple(texture_id.shape) + (4,))
    tid = torch.clamp_min(texture_id, 0).long()
    filt = bank.filters[tid]
    wrap_u = bank.wraps[tid, 0]
    wrap_v = bank.wraps[tid, 1]

    # v flip: image row 0 is the top.
    u = uv[..., 0]
    v = 1.0 - uv[..., 1]

    # Wrap in float uv space first (Repeat), then sample.
    fu = torch.where(wrap_u == WRAP_REPEAT, u - torch.floor(u),
                     torch.clamp(u, 0.0, 1.0))
    fv = torch.where(wrap_v == WRAP_REPEAT, v - torch.floor(v),
                     torch.clamp(v, 0.0, 1.0))
    if trilinear and footprint_uv is not None:
        size = torch.maximum(bank.sizes[tid, 0], bank.sizes[tid, 1]).to(
            torch.float32)
        lod = torch.log2(maximum(footprint_uv * size, 1.0))
        lod = torch.where(filt == FILTER_TRILINEAR, lod, 0.0)
        top = bank.n_levels[tid].long() - 1
        lod = torch.minimum(maximum(lod, 0.0), top.to(torch.float32))
        l0 = lod.to(torch.int64)
        l1 = torch.minimum(l0 + 1, top)
        tl = (lod - l0.to(torch.float32))[..., None]
        out = (_sample_level(bank, tid, fu, fv, wrap_u, wrap_v, filt, l0)
               * (1.0 - tl)
               + _sample_level(bank, tid, fu, fv, wrap_u, wrap_v, filt, l1)
               * tl)
    else:
        out = _sample_level(bank, tid, fu, fv, wrap_u, wrap_v, filt,
                            torch.zeros_like(tid))
    return torch.where((texture_id < 0)[..., None], default, out)


# -- byte-format conversions (Math/FixedPointTypes.h UNorm8/UNorm16) ---------

def unorm8_encode(x):
    return (torch.clamp(x, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def unorm8_decode(b):
    return b.to(torch.float32) / 255.0


def unorm16_encode(x):
    """→ int32 holding the uint16 value (torch has no uint16 arithmetic)."""
    return (torch.clamp(x, 0.0, 1.0) * 65535.0 + 0.5).to(torch.int32)


def unorm16_decode(b):
    return b.to(torch.float32) / 65535.0
