"""Image IO of the port against the JAX package and PIL.

The port decodes PNG without PIL: its array must be PIL's
(``np.asarray(PIL.Image.open(path))``, which the JAX package's
``load_image`` and glTF reader hand on) for every colour type, on files that
PIL writes with its adaptive filters (None, Sub, Up and Paeth occur; PIL's
heuristic never picks Average) and on files written here with each of the
five filters (Average among them), read by PIL too. ``load_image`` against the JAX package's with
and without the sRGB decode, the self-contained EXR writer and reader
across the two packages bit for bit, the cases that raise, and
``PixelImage`` and the summed-area table against the JAX package's.
"""

import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from bifrost3d_tpu.io import image as jimage
from bifrost3d_tpu.io import pixel_image as jpix
from bifrost3d_tpu.io import texture as jtex
from bifrost3d_tpu.math import color as jcolor

from bifrost3d_tpu_torch.io import image as timage
from bifrost3d_tpu_torch.io import pixel_image as tpix
from bifrost3d_tpu_torch.io import texture as ttex
from bifrost3d_tpu_torch.math import color as tcolor
from torch_parity import assert_f64_anchored
from torch_scene_files import FILTERS, encode_png

# PIL mode of each PNG colour type PIL writes at 8 bits.
MODES = {0: "L", 2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}


def _pil_png(path, color_type, seed, h=37, w=29):
    """A PNG written by PIL: a smooth ramp plus noise, every sixth row
    blank (so that its adaptive filter choice varies from row to row: Sub,
    Up, Paeth, and None on a blank row), or for type 3 a 256-colour
    palette image (8-bit indices, which PIL writes unfiltered)."""
    rng = np.random.default_rng(seed)
    if color_type == 3:
        img = Image.fromarray(rng.integers(0, 256, (h, w)).astype(np.uint8),
                              "P")
        img.putpalette(rng.integers(0, 256, 768).astype(np.uint8).tolist())
    else:
        c = len(MODES[color_type])
        yy, xx = np.mgrid[0:h, 0:w]
        ramp = (np.sin(xx / 3.0) * 60 + yy * 4 + 60)[..., None]
        noise = rng.normal(0, 6 + 20 * (yy % 3 == 0)[..., None], (h, w, c))
        px = np.clip(ramp + noise + 30 * np.arange(c), 0, 255).astype(np.uint8)
        px[1::6] = 0
        img = Image.fromarray(px[..., 0] if c == 1 else px, MODES[color_type])
    img.save(path)
    return path


def _filters_of(path):
    """The scanline filter types of an 8-bit PNG file."""
    data = open(path, "rb").read()
    w, h, _, color_type = struct.unpack(">IIBB", data[16:26])
    idat, pos = b"", 8
    while pos < len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    c = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(h, w * c + 1)[:, 0].tolist())


@pytest.mark.parametrize("color_type", sorted(MODES))
def test_png_decoder_matches_pil(color_type, tmp_path):
    path = _pil_png(str(tmp_path / "x.png"), color_type, color_type)
    got = timage.read_png(path)
    ref = np.asarray(Image.open(path))
    assert got.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


def test_pil_files_use_four_filters(tmp_path):
    seen = set()
    for color_type in (0, 2, 4, 6):
        for seed in range(3):
            seen |= _filters_of(_pil_png(
                str(tmp_path / f"x{color_type}{seed}.png"), color_type,
                10 * seed + color_type))
    assert seen == {FILTERS[f] for f in ("none", "sub", "up", "paeth")}, seen


@pytest.mark.parametrize("filters", [*FILTERS, list(FILTERS)])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_decoder_undoes_each_filter(filters, channels, tmp_path):
    rng = np.random.default_rng(channels)
    px = rng.integers(0, 256, (23, 17, channels)).astype(np.uint8)
    data = encode_png(px, filters)
    path = tmp_path / "f.png"
    path.write_bytes(data)
    ref = np.asarray(Image.open(path))
    np.testing.assert_array_equal(timage.decode_png(data), ref)
    np.testing.assert_array_equal(ref.reshape(px.shape), px)


@pytest.mark.parametrize("colors", [2, 4, 16])
def test_low_bit_palette_gives_pil_indices(colors, tmp_path):
    """PIL writes a palette of up to 16 colours at 1, 2 or 4 bits."""
    rng = np.random.default_rng(colors)
    img = Image.fromarray(rng.integers(0, colors, (19, 23)).astype(np.uint8),
                          "P")
    img.putpalette(rng.integers(0, 256, 3 * colors).astype(np.uint8).tolist())
    path = str(tmp_path / "p.png")
    img.save(path)
    np.testing.assert_array_equal(timage.read_png(path),
                                  np.asarray(Image.open(path)))


@pytest.mark.parametrize("to_linear", [False, True])
@pytest.mark.parametrize("color_type", sorted(MODES))
def test_load_image_matches_jax(color_type, to_linear, tmp_path):
    """Without the sRGB decode the arrays are equal; with it, the port's
    array is its srgb_to_linear of that array, held against JAX's through
    assert_f64_anchored. A palette file hands on its indices in both."""
    path = _pil_png(str(tmp_path / "x.png"), color_type, 7 + color_type)
    ref = np.asarray(jimage.load_image(path, to_linear=to_linear))
    got = timage.load_image(path, to_linear=to_linear)
    assert got.dtype == np.float32 and got.shape == ref.shape
    raw = timage.load_image(path, to_linear=False)
    np.testing.assert_array_equal(raw, np.asarray(
        jimage.load_image(path, to_linear=False)))
    if not to_linear:
        np.testing.assert_array_equal(got, ref)
        return
    np.testing.assert_array_equal(
        got[..., :3], tcolor.srgb_to_linear(torch.tensor(raw[..., :3])).numpy())
    np.testing.assert_array_equal(got[..., 3:], raw[..., 3:])
    assert_f64_anchored(tcolor.srgb_to_linear, jcolor.srgb_to_linear,
                        np.ascontiguousarray(raw[..., :3]))


def test_load_image_scales_only_above_one_and_a_half(tmp_path):
    """An 8-bit image of 0s and 1s is not divided by 255, in either
    package (JAX's ``load_image`` divides only where the maximum exceeds
    1.5)."""
    px = np.random.default_rng(2).integers(0, 2, (8, 8, 3)).astype(np.uint8)
    path = tmp_path / "bits.png"
    path.write_bytes(encode_png(px, "sub"))
    got = timage.load_image(str(path), to_linear=False)
    np.testing.assert_array_equal(got, px.astype(np.float32))
    np.testing.assert_array_equal(got, np.asarray(
        jimage.load_image(str(path), to_linear=False)))


def test_linear_to_srgb_matches_jax():
    x = np.random.default_rng(4).uniform(-0.1, 1.2, 4096).astype(np.float32)
    x[:3] = (0.0, 0.0031308, 1.0)
    assert_f64_anchored(tcolor.linear_to_srgb, jcolor.linear_to_srgb, x)


def test_srgb_encode_u8_matches_jax():
    x = np.random.default_rng(5).uniform(-0.1, 1.2, (64, 64, 3))
    got = timage.srgb_encode_u8(x.astype(np.float32))
    ref = jimage.srgb_encode_u8(x.astype(np.float32))
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    assert (got == ref).mean() > 0.999


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_exr_round_trip_across_packages(writer, tmp_path):
    rng = np.random.default_rng(6)
    img = rng.normal(0, 10, (13, 21, 3)).astype(np.float32)
    img[0, 0] = (np.inf, -0.0, 1e-40)
    path = str(tmp_path / "x.exr")
    (timage.save_exr if writer == "port" else jimage.save_exr)(path, img)
    for load in (timage.load_exr, jimage.load_exr, timage.load_image):
        back = np.asarray(load(path))
        assert back.dtype == np.float32
        np.testing.assert_array_equal(back.view(np.uint32),
                                      img.view(np.uint32))
    other = str(tmp_path / "y.exr")
    (jimage.save_exr if writer == "port" else timage.save_exr)(other, img)
    assert open(path, "rb").read() == open(other, "rb").read()


def test_save_image_writes_exr_linear(tmp_path):
    img = np.random.default_rng(7).uniform(0, 4, (5, 6, 3)).astype(np.float32)
    path = str(tmp_path / "x.exr")
    timage.save_image(path, torch.tensor(img))
    np.testing.assert_array_equal(jimage.load_exr(path), img)


def _with_header(data, **fields):
    """A PNG's bytes with IHDR fields replaced (bit depth, interlace)."""
    w, h, depth, ct, comp, filt, lace = struct.unpack(">IIBBBBB", data[16:29])
    depth = fields.get("depth", depth)
    lace = fields.get("interlace", lace)
    body = struct.pack(">IIBBBBB", w, h, depth, ct, comp, filt, lace)
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + body) & 0xFFFFFFFF)
    return data[:16] + body + crc + data[33:]


def test_sixteen_bit_and_interlaced_png_raise(tmp_path):
    grey16 = (np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000)
    Image.fromarray(grey16).save(tmp_path / "g16.png")
    ref = np.asarray(Image.open(tmp_path / "g16.png"))
    assert ref.dtype != np.uint8
    with pytest.raises(NotImplementedError, match="16-bit"):
        timage.read_png(str(tmp_path / "g16.png"))
    data = encode_png(np.zeros((4, 4, 3), np.uint8), "none")
    with pytest.raises(NotImplementedError, match="interlaced"):
        timage.decode_png(_with_header(data, interlace=1))
    with pytest.raises(NotImplementedError, match="16-bit"):
        timage.decode_png(_with_header(data, depth=16))


def _raw_png(rows: bytes, w, h, depth, color_type, interlace=0) -> bytes:
    """A PNG of already filtered scanline bytes."""
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    header = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


def _low_bit_grey_png(values, depth) -> bytes:
    """Grey values [h, w] < 2**depth packed MSB first, rows unfiltered."""
    h, w = values.shape
    bits = ((values[..., None] >> np.arange(depth - 1, -1, -1)) & 1)
    packed = np.packbits(bits.reshape(h, w * depth).astype(np.uint8), axis=1)
    return _raw_png(b"".join(b"\x00" + r.tobytes() for r in packed), w, h,
                    depth, 0)


def _adam7_png(pixels) -> bytes:
    """uint8 RGB [h, w, 3] as an Adam7-interlaced PNG, rows unfiltered."""
    h, w, _ = pixels.shape
    rows = b""
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8),
                           (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                           (0, 1, 1, 2)):
        sub = pixels[y0::dy, x0::dx]
        if sub.size:
            rows += b"".join(b"\x00" + r.tobytes() for r in sub)
    return _raw_png(rows, w, h, 8, 2, interlace=1)


def _png_cases(tmp_path):
    """PNGs the PIL-free decoder refuses: 16-bit grey and RGB (PIL-written),
    1-, 2- and 4-bit grey, and Adam7-interlaced RGB."""
    rng = np.random.default_rng(11)
    cases = {}
    Image.fromarray((rng.integers(0, 65536, (9, 7))).astype(np.uint16)
                    ).save(tmp_path / "grey16.png")
    cases["grey16"] = tmp_path / "grey16.png"
    rgb16 = rng.integers(0, 65536, (6, 5, 3)).astype(">u2")
    (tmp_path / "rgb16.png").write_bytes(_raw_png(
        b"".join(b"\x00" + r.tobytes() for r in rgb16.reshape(6, 15)), 5, 6,
        16, 2))
    cases["rgb16"] = tmp_path / "rgb16.png"
    for depth in (1, 2, 4):
        path = tmp_path / f"grey{depth}.png"
        path.write_bytes(_low_bit_grey_png(
            rng.integers(0, 1 << depth, (7, 11)), depth))
        cases[f"grey{depth}"] = path
    (tmp_path / "adam7.png").write_bytes(_adam7_png(
        rng.integers(0, 256, (13, 10, 3)).astype(np.uint8)))
    cases["adam7"] = tmp_path / "adam7.png"
    return cases


@pytest.mark.parametrize("case", ["grey16", "rgb16", "grey1", "grey2",
                                  "grey4", "adam7"])
@pytest.mark.parametrize("to_linear", [False, True])
def test_load_image_reads_other_pngs_through_pil(case, to_linear, tmp_path):
    path = str(_png_cases(tmp_path)[case])
    with pytest.raises(NotImplementedError):
        timage.read_png(path)                      # the PIL-free decoder
    want = np.asarray(jimage.load_image(path, to_linear))
    got = timage.load_image(path, to_linear)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_other_pngs_raise_without_pil(tmp_path, monkeypatch):
    cases = _png_cases(tmp_path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    for path in cases.values():
        with pytest.raises(NotImplementedError):
            timage.load_image(str(path))


@pytest.mark.parametrize("ext", ["jpg", "bmp", "tga"])
def test_save_image_other_formats_through_pil(ext, tmp_path):
    img = np.random.default_rng(12).uniform(0, 1.2, (9, 8, 3)).astype(
        np.float32)
    for from_linear in (True, False):
        timage.save_image(str(tmp_path / f"p.{ext}"), img, from_linear)
        jimage.save_image(str(tmp_path / f"j.{ext}"), img, from_linear)
        assert (tmp_path / f"p.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes()


def test_jpeg_needs_pil(tmp_path, monkeypatch):
    path = tmp_path / "photo.jpg"
    Image.fromarray(np.full((8, 8, 3), 128, np.uint8)).save(path)
    np.testing.assert_array_equal(timage.load_image(str(path), False),
                                  np.asarray(jimage.load_image(str(path),
                                                               False)))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="photo.jpg"):
        timage.load_image(str(path))


@pytest.mark.parametrize("fmt", [tpix.ALPHA8, tpix.INTENSITY8, tpix.RGB24,
                                 tpix.RGBA32, tpix.INTENSITY_FLOAT,
                                 tpix.RGB_FLOAT, tpix.RGBA_FLOAT])
def test_pixel_image_matches_jax(fmt):
    rng = np.random.default_rng(fmt)
    c = tpix.channel_count(fmt)
    data = (rng.integers(0, 256, (12, 10, c)).astype(np.uint8)
            if tpix.is_byte_format(fmt)
            else rng.uniform(0, 2, (12, 10, c)).astype(np.float32))
    got = tpix.PixelImage(fmt, (10, 12), gamma=2.2, data=data, mipmap_count=3)
    ref = jpix.PixelImage(fmt, (10, 12), gamma=2.2, data=data, mipmap_count=3)
    assert got.mipmap_count == ref.mipmap_count == 3
    for level in range(3):
        np.testing.assert_array_equal(got.mip(level), ref.mip(level))
    np.testing.assert_array_equal(got.get_pixel(3, 4, mip=1),
                                  ref.get_pixel(3, 4, mip=1))
    got.set_pixel((0.25, 0.5, 0.75, 1.0), 1, 2)
    ref.set_pixel((0.25, 0.5, 0.75, 1.0), 1, 2)
    np.testing.assert_array_equal(got.data, ref.data)
    for new in (tpix.RGBA_FLOAT, tpix.INTENSITY8):
        np.testing.assert_array_equal(got.change_format(new, 1.0).data,
                                      ref.change_format(new, 1.0).data)
    np.testing.assert_array_equal(got.summed_area_table(),
                                  ref.summed_area_table())


def test_summed_area_table_matches_jax():
    img = np.random.default_rng(9).uniform(0, 1, (9, 11, 3))
    sat = ttex.summed_area_table(img)
    np.testing.assert_array_equal(sat, jtex.summed_area_table(img))
    for box in ((0, 0, 10, 8), (2, 3, 5, 7), (4, 0, 4, 0)):
        np.testing.assert_array_equal(ttex.sat_region_average(sat, *box),
                                      jtex.sat_region_average(sat, *box))
        x0, y0, x1, y1 = box
        np.testing.assert_allclose(ttex.sat_region_average(sat, *box),
                                   img[y0:y1 + 1, x0:x1 + 1].mean((0, 1)))
