"""Image loading and saving: PNG read and written with the standard library,
the self-contained EXR reader and writer, other formats through PIL.

Port of ``bifrost3d_tpu/io/image.py`` (``load_image``, ``save_image``,
``save_exr``, ``load_exr``, ``srgb_encode_u8``). The JAX package reads and
writes PNG through PIL; this port decodes and encodes PNG with ``zlib``,
``struct`` and numpy, so it runs where PIL is not installed.

:func:`decode_png` returns what ``np.asarray(PIL.Image.open(path))`` does
for an 8-bit, non-interlaced PNG of colour type 0 (grey, [h, w]), 2 (RGB),
3 (palette: PIL's palette *indices*, [h, w], not colours; 1-, 2- and 4-bit
palettes unpack to the same indices), 4 (grey + alpha) or 6 (RGBA) as
uint8. Those arrays are what the JAX package's ``load_image`` and glTF
image reader hand on. A 16-bit, a grey 1/2/4-bit or an Adam7-interlaced
PNG raises ``NotImplementedError`` there; :func:`decode_image_bytes` (so
``load_image``) reads those through PIL where it is installed, as the JAX
package does. Rows filtered None, Sub or Up are
undone a row at a time (Sub as a per-channel ``cumsum`` mod 256); an image
with an Average or Paeth row is undone along its anti-diagonals, whose
bytes do not depend on each other: h + w - 1 vector steps instead of a
step per pixel.

Other formats (JPG, TGA, HDR) are read, and formats other than PNG and EXR
written, through PIL where it is installed, as the JAX package does;
without it they raise ``ImportError`` (reading) or ``NotImplementedError``
(writing).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from bifrost3d_tpu_torch.math.color import linear_to_srgb, srgb_to_linear

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_FILTER_NONE, _FILTER_SUB, _FILTER_UP, _FILTER_AVERAGE, _FILTER_PAETH = range(5)


def _to_numpy(image) -> np.ndarray:
    if hasattr(image, "detach"):
        image = image.detach().cpu().numpy()
    return np.asarray(image)


# -- PNG -----------------------------------------------------------------------

def _unfilter_rows(filt: np.ndarray, kinds: np.ndarray, bpp: int):
    """Rows of filter None, Sub or Up: one row at a time, vectorised.
    ``filt`` [h, row_bytes] uint8 → the raw bytes."""
    out = np.empty_like(filt)
    prior = np.zeros(filt.shape[1], np.uint8)
    for y, kind in enumerate(kinds):
        row = filt[y]
        if kind == _FILTER_SUB:
            row = np.cumsum(row.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == _FILTER_UP:
            row = row + prior
        out[y] = row
        prior = out[y]
    return out


def _unfilter_diagonals(filt: np.ndarray, kinds: np.ndarray, bpp: int):
    """Any mix of the five filters along the image's anti-diagonals: the
    unit (y, x) of ``bpp`` bytes depends only on (y, x - 1), (y - 1, x) and
    (y - 1, x - 1), so one diagonal is one vector step."""
    h, row_bytes = filt.shape
    w = row_bytes // bpp
    f = filt.reshape(h, w, bpp).astype(np.int16)
    # One row and one column of zeros before the image: the left and up
    # neighbours outside it.
    out = np.zeros((h + 1, w + 1, bpp), np.int16)
    kinds = kinds.astype(np.int16)
    for k in range(h + w - 1):
        y = np.arange(max(0, k - w + 1), min(h - 1, k) + 1)
        x = k - y
        a = out[y + 1, x]          # left
        b = out[y, x + 1]          # up
        c = out[y, x]              # up-left
        kind = kinds[y][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([kind == _FILTER_SUB, kind == _FILTER_UP,
                          kind == _FILTER_AVERAGE, kind == _FILTER_PAETH],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[y + 1, x + 1] = (f[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8).reshape(h, row_bytes)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → uint8 array as ``np.asarray(PIL.Image.open(...))``."""
    if data[:8] != _PNG_MAGIC:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, color_type, _, _, interlace = header
    if interlace:
        raise NotImplementedError("Adam7-interlaced PNG is not supported")
    if depth == 16:
        raise NotImplementedError("16-bit PNG is not supported")
    if color_type not in _PNG_CHANNELS:
        raise ValueError(f"PNG colour type {color_type} is not valid")
    if depth != 8 and color_type != 3:
        raise NotImplementedError(
            f"{depth}-bit PNG of colour type {color_type} is not supported")
    channels = _PNG_CHANNELS[color_type]
    row_bytes = (w * channels * depth + 7) // 8
    bpp = max(1, channels * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[:h * (row_bytes + 1)].reshape(h, row_bytes + 1)
    kinds, filt = raw[:, 0], raw[:, 1:]
    if int(kinds.max(initial=0)) > _FILTER_PAETH:
        raise ValueError(f"PNG filter type {int(kinds.max())} is not valid")
    if np.isin(kinds, (_FILTER_AVERAGE, _FILTER_PAETH)).any():
        pixels = _unfilter_diagonals(filt, kinds, bpp)
    else:
        pixels = _unfilter_rows(filt, kinds, bpp)
    if depth < 8:      # palette indices packed 8 // depth to a byte, MSB first
        bits = np.unpackbits(pixels, axis=1).reshape(h, -1, depth)[:, :w]
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        pixels = (bits * weights).sum(-1).astype(np.uint8)
    pixels = pixels.reshape(h, w, channels)
    return pixels[..., 0] if channels == 1 else pixels


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


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
        f.write(_PNG_MAGIC)
        # 8-bit depth, colour type 2 (RGB), default compression/filter/interlace.
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))


def _pil_image():
    """PIL's ``Image`` module, or None where PIL is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def decode_image_bytes(data: bytes, name: str) -> np.ndarray:
    """An encoded image → ``np.asarray(PIL.Image.open(...))``: PNG by
    :func:`decode_png`, a PNG it does not decode (16-bit, grey below 8
    bits, interlaced) and anything else through PIL (``name`` says which
    file in the error where PIL is not installed)."""
    if data[:8] == _PNG_MAGIC:
        try:
            return decode_png(data)
        except NotImplementedError:
            if _pil_image() is None:
                raise
    image = _pil_image()
    if image is None:
        raise ImportError(f"{name}: only PNG and EXR are read without PIL, "
                          "which is not installed")
    import io
    return np.asarray(image.open(io.BytesIO(data)))


# -- load / save ---------------------------------------------------------------

def load_image(path: str, to_linear: bool = True) -> np.ndarray:
    """→ float32 [h, w, 3|4] (linear if ``to_linear`` and the file is LDR).

    As the JAX package's: 8-bit values are divided by 255 only where the
    image's maximum exceeds 1.5 (an image of 0s and 1s stays unscaled),
    and a palette PNG hands on its indices."""
    if path.lower().endswith(".exr"):
        return load_exr(path)
    with open(path, "rb") as f:
        arr = decode_image_bytes(f.read(), path).astype(np.float32)
    if arr.max() > 1.5:
        arr = arr / 255.0
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, axis=-1)
    if to_linear:
        rgb = srgb_to_linear(torch.from_numpy(
            np.ascontiguousarray(arr[..., :3]))).numpy()
        arr = (np.concatenate([rgb, arr[..., 3:]], axis=-1)
               if arr.shape[-1] == 4 else rgb)
    return arr


def srgb_encode_u8(linear_rgb) -> np.ndarray:
    """Linear [0, 1] → sRGB-encoded uint8."""
    c = np.clip(_to_numpy(linear_rgb).astype(np.float32), 0.0, 1.0)
    srgb = linear_to_srgb(torch.from_numpy(c)).numpy()
    return (srgb * 255.0 + 0.5).astype(np.uint8)


def save_image(path: str, linear_rgb, from_linear: bool = True) -> None:
    """Save float [h, w, 3] (numpy or tensor): EXR linear; PNG, and through
    PIL any other format it knows, sRGB-encoded when ``from_linear``."""
    arr = _to_numpy(linear_rgb).astype(np.float32)
    if path.lower().endswith(".exr"):
        save_exr(path, arr)
        return
    png = path.lower().endswith(".png")
    image = None if png else _pil_image()
    if not png and image is None:
        raise NotImplementedError(
            f"only PNG and EXR are written without PIL, not "
            f"{path.rsplit('.', 1)[-1]}")
    data = srgb_encode_u8(arr) if from_linear else (
        np.clip(arr, 0, 1) * 255 + 0.5).astype(np.uint8)
    if png:
        write_png(path, data)
    else:
        image.fromarray(data).save(path)


# -- minimal EXR (float32, uncompressed scanlines) ----------------------------

_EXR_MAGIC = 20000630


def save_exr(path: str, image) -> None:
    """Write [h, w, 3] float32 as an uncompressed scanline EXR."""
    img = _to_numpy(image).astype(np.float32)
    h, w = img.shape[:2]
    channels = ["B", "G", "R"]  # alphabetical, EXR requirement

    def attr(name, type_name, payload):
        return (name.encode() + b"\0" + type_name.encode() + b"\0"
                + struct.pack("<i", len(payload)) + payload)

    chlist = b""
    for c in channels:
        chlist += (c.encode() + b"\0" + struct.pack("<i", 2)  # FLOAT
                   + struct.pack("<i", 0) + struct.pack("<ii", 1, 1))
    chlist += b"\0"

    header = b""
    header += attr("channels", "chlist", chlist)
    header += attr("compression", "compression", struct.pack("<B", 0))
    header += attr("dataWindow", "box2i", struct.pack("<4i", 0, 0, w - 1, h - 1))
    header += attr("displayWindow", "box2i",
                   struct.pack("<4i", 0, 0, w - 1, h - 1))
    header += attr("lineOrder", "lineOrder", struct.pack("<B", 0))
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    offset_table_pos = 8 + len(header)
    data_start = offset_table_pos + 8 * h
    line_size = 8 + w * 4 * 3
    offsets = data_start + line_size * np.arange(h, dtype=np.uint64)
    # Each line: its y, its byte count, then the B, G and R rows.
    lines = np.empty((h, line_size), np.uint8)
    lines[:, :8] = np.frombuffer(
        np.stack([np.arange(h), np.full(h, w * 12)], -1).astype("<i4")
        .tobytes(), np.uint8).reshape(h, 8)
    lines[:, 8:] = np.ascontiguousarray(
        img[..., 2::-1].transpose(0, 2, 1)).astype("<f4").view(
            np.uint8).reshape(h, -1)
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _EXR_MAGIC, 2))
        f.write(header)
        f.write(offsets.astype("<u8").tobytes())
        f.write(lines.tobytes())


def load_exr(path: str) -> np.ndarray:
    """Read EXRs written by :func:`save_exr` (float32, uncompressed)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, _version = struct.unpack_from("<ii", data, 0)
    assert magic == _EXR_MAGIC, "not an EXR file"
    pos = 8
    attrs = {}
    while data[pos] != 0:
        name_end = data.index(b"\0", pos)
        name = data[pos:name_end].decode()
        pos = name_end + 1
        type_end = data.index(b"\0", pos)
        pos = type_end + 1
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        attrs[name] = data[pos:pos + size]
        pos += size
    pos += 1
    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    compression = attrs["compression"][0]
    assert compression == 0, "only uncompressed EXR supported"
    # Channel names, alphabetical in the file.
    chl = attrs["channels"]
    names = []
    cpos = 0
    while chl[cpos] != 0:
        nend = chl.index(b"\0", cpos)
        names.append(chl[cpos:nend].decode())
        cpos = nend + 1 + 16
    offsets = struct.unpack_from(f"<{h}Q", data, pos)
    img = np.zeros((h, w, 3), np.float32)
    ch_to_idx = {"R": 0, "G": 1, "B": 2}
    for off in offsets:
        y, _size = struct.unpack_from("<ii", data, off)
        rows = np.frombuffer(data, "<f4", w * len(names), off + 8).reshape(
            len(names), w)
        for name, row in zip(names, rows):
            if name in ch_to_idx:
                img[y, :, ch_to_idx[name]] = row
    return img
