"""Image saving: PNG written with the standard library.

Port of the PNG path of ``bifrost3d_tpu/io/image.py`` (``srgb_encode_u8``,
``save_image``). The JAX package writes through PIL; this port needs only
``zlib`` and ``struct`` for the file and numpy for the sRGB encode, so it
runs where PIL is not installed.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _linear_to_srgb(c: np.ndarray) -> np.ndarray:
    c = np.maximum(c, 0.0)
    return np.where(c <= 0.0031308, c * 12.92,
                    1.055 * np.power(c, 1.0 / 2.4) - 0.055).astype(np.float32)


def srgb_encode_u8(linear_rgb) -> np.ndarray:
    """Linear [0, 1] → sRGB-encoded uint8."""
    c = np.clip(np.asarray(linear_rgb, np.float32), 0.0, 1.0)
    return (_linear_to_srgb(c) * 255.0 + 0.5).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, pixels: np.ndarray) -> None:
    """uint8 RGB [h, w, 3] → an 8-bit PNG file."""
    pixels = np.ascontiguousarray(pixels, np.uint8)
    h, w, c = pixels.shape
    if c != 3:
        raise ValueError(f"write_png takes [h, w, 3] RGB, not {pixels.shape}")
    # Each scanline is prefixed by filter type 0 (none).
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          pixels.reshape(h, w * 3)], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        # 8-bit depth, colour type 2 (RGB), default compression/filter/interlace.
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))


def save_image(path: str, linear_rgb, from_linear: bool = True) -> None:
    """Save float [h, w, 3] (numpy or tensor) as a PNG, sRGB-encoded when
    ``from_linear``."""
    if not path.lower().endswith(".png"):
        raise NotImplementedError(
            f"only PNG output is ported yet, not {path.rsplit('.', 1)[-1]}")
    if hasattr(linear_rgb, "detach"):
        linear_rgb = linear_rgb.detach().cpu().numpy()
    arr = np.asarray(linear_rgb, np.float32)
    data = srgb_encode_u8(arr) if from_linear else (
        np.clip(arr, 0, 1) * 255 + 0.5).astype(np.uint8)
    write_png(path, data)
