"""Morton (Z-order) encoding on uint32 values carried in int64 tensors.

Port of ``bifrost3d_tpu/math/morton.py`` (``morton_encode_2d``,
``morton_decode_2d``, ``morton_encode_3d``), bit-exact. The 3-D code keys
the ray sorts in front of the BVH trace kernel.
"""

from __future__ import annotations


def _part_1by1(x):
    x = x & 0x0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def _compact_1by1(x):
    x = x & 0x55555555
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    x = (x | (x >> 8)) & 0x0000FFFF
    return x


def _part_1by2(x):
    x = x & 0x000003FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_encode_2d(x, y):
    return _part_1by1(x) | (_part_1by1(y) << 1)


def morton_decode_2d(code):
    return _compact_1by1(code), _compact_1by1(code >> 1)


def morton_encode_3d(x, y, z):
    """Interleave 10-bit x/y/z (int64 tensors) into a 30-bit Morton code."""
    return _part_1by2(x) | (_part_1by2(y) << 1) | (_part_1by2(z) << 2)
