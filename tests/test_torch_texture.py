"""The port's textures (io/texture.py) against the JAX package.

Images and uvs are made from a seed with numpy and fed to both packages:
the atlas and its metadata must be equal, a NEAREST fetch must read the same
texel, a bilinear fetch agree to 1e-6, over both wraps, negative uvs and
uvs on texel borders.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bifrost3d_tpu.io import texture as jtex
from bifrost3d_tpu_torch.io import texture as ttex
from torch_parity import _to_numpy

FILTERS = {"nearest": ttex.FILTER_NONE, "linear": ttex.FILTER_LINEAR}
WRAPS = {"clamp": ttex.WRAP_CLAMP, "repeat": ttex.WRAP_REPEAT}


def _textures(seed=0):
    """Every filter x wrap_u x wrap_v once, on images of different sizes and
    channel counts, each texel distinct."""
    rng = np.random.default_rng(seed)
    sizes = [(2, 2, 4), (17, 17, 1), (8, 5, 3), (3, 16, 4), (1, 7, 2),
             (6, 6, 4), (9, 4, 4), (4, 4, 1)]
    out = []
    combos = [(f, wu, wv) for f in FILTERS.values() for wu in WRAPS.values()
              for wv in WRAPS.values()]
    for (h, w, c), (f, wu, wv) in zip(sizes, combos):
        out.append({"image": rng.uniform(0.05, 1.0, size=(h, w, c)
                                         ).astype(np.float32),
                    "filter": f, "wrap_u": wu, "wrap_v": wv})
    return out


@pytest.fixture(scope="module")
def banks():
    textures = _textures()
    return (textures, jtex.TextureBank.build(textures),
            ttex.TextureBank.build(textures, device="cpu"))


def _uvs(seed, n, w, h):
    """Random uvs in [-3, 3], then uvs on texel borders (k / size), on
    texel centres ((k + 0.5) / size, where NEAREST rounds a half), both also
    negative and past 1, then the corners."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-3.0, 3.0, size=(n, 2)).astype(np.float32)
    k = np.arange(-2 * max(w, h), 3 * max(w, h) + 1, dtype=np.float32)
    borders = np.stack([k / w, k[::-1] / h], -1)
    centres = np.stack([(k + 0.5) / w, (k + 0.5) / h], -1)
    mixed = np.stack([k / w, (k + 0.5) / h], -1)
    corners = np.asarray([[0, 0], [1, 1], [0, 1], [1, 0], [-1, -1], [2, 2],
                          [0.5, 0.5], [-0.0, 1e-7]], np.float32)
    return np.concatenate([uv, borders, centres, mixed, corners]
                          ).astype(np.float32)


def test_constants_match_jax():
    for name in ("FILTER_NONE", "FILTER_LINEAR", "FILTER_TRILINEAR",
                 "WRAP_CLAMP", "WRAP_REPEAT", "MAX_MIP_LEVELS"):
        assert getattr(ttex, name) == getattr(jtex, name), name


@pytest.mark.parametrize("shape", [(8, 8, 4), (17, 17, 1), (5, 12, 3),
                                   (1, 1, 4), (2, 9, 2)])
def test_fill_mipmaps_matches_jax(shape):
    img = np.random.default_rng(1).uniform(size=shape).astype(np.float32)
    ref = jtex.fill_mipmaps(img)
    got = ttex.fill_mipmaps(img)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_bank_build_matches_jax(banks):
    textures, jbank, bank = banks
    assert bank.count == jbank.count == len(textures)
    for name, ref in _to_numpy(jbank).items():
        got = getattr(bank, name).numpy()
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
    assert not bank.has_trilinear() and not jbank.has_trilinear()


def test_bank_from_numpy_round_trip(banks):
    _, jbank, bank = banks
    carried = ttex.TextureBank.from_numpy(_to_numpy(jbank), device="cpu")
    for a, b in zip(carried, bank):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_empty_bank_matches_jax():
    jbank = jtex.TextureBank.build([])
    bank = ttex.TextureBank.build([], device="cpu")
    assert bank.count == jbank.count == 0
    for name, ref in _to_numpy(jbank).items():
        assert tuple(getattr(bank, name).shape) == ref.shape, name
    ids = torch.tensor([0, -1, 3])
    uv = torch.rand(3, 2)
    for b in (bank, None):
        out = ttex.sample_texture(b, ids, uv)
        assert out.shape == (3, 4) and bool((out == 1.0).all())
    default = torch.tensor([0.1, 0.2, 0.3, 0.4])
    out = ttex.sample_texture(bank, ids, uv, default=default)
    np.testing.assert_array_equal(out.numpy(), np.tile(default.numpy(), (3, 1)))


def test_has_trilinear_and_the_unported_filter():
    """The trilinear filter is ported (it raised before): with a footprint
    of the whole texture the fetch reads the last mip level, JAX's
    value."""
    img = np.random.default_rng(4).random((4, 4, 4)).astype(np.float32)
    tri = [{"image": img, "filter": ttex.FILTER_TRILINEAR}]
    bank = ttex.TextureBank.build(tri, device="cpu")
    jbank = jtex.TextureBank.build(tri)
    assert bank.has_trilinear() and jbank.has_trilinear()
    assert int(bank.n_levels[0]) == 3
    uv = np.random.default_rng(5).random((2, 2)).astype(np.float32)
    got = ttex.sample_texture(bank, torch.zeros(2, dtype=torch.int32),
                              torch.tensor(uv), footprint_uv=torch.ones(2),
                              trilinear=True)
    ref = jtex.sample_texture(jbank, jnp.zeros(2, jnp.int32), jnp.asarray(uv),
                              footprint_uv=jnp.ones(2), trilinear=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(
        img.mean((0, 1)), (2, 4)), rtol=1e-5)


@pytest.mark.parametrize("index", range(8))
def test_sample_texture_matches_jax(banks, index):
    """Texture ``index`` of the bank: NEAREST reads the very same texel
    (exact equality), bilinear agrees to 1e-6."""
    textures, jbank, bank = banks
    h, w = textures[index]["image"].shape[:2]
    uv = _uvs(10 + index, 2000, w, h)
    ids = np.full(uv.shape[0], index, np.int32)
    ref = np.asarray(jtex.sample_texture(jbank, jnp.asarray(ids),
                                         jnp.asarray(uv)))
    got = ttex.sample_texture(bank, torch.tensor(ids), torch.tensor(uv)
                              ).numpy()
    assert got.shape == ref.shape == (uv.shape[0], 4)
    if textures[index]["filter"] == ttex.FILTER_NONE:
        np.testing.assert_array_equal(got, ref)
        # Each value is a texel of the image (or the alpha fill).
        texels = np.unique(textures[index]["image"])
        assert np.isin(got[:, 0], texels).all()
    else:
        np.testing.assert_allclose(got, ref, rtol=0.0, atol=1e-6)


def test_sample_texture_mixed_ids_and_default(banks):
    _, jbank, bank = banks
    rng = np.random.default_rng(30)
    n = 4000
    ids = rng.integers(-1, 8, size=n).astype(np.int32)
    uv = rng.uniform(-2.0, 2.0, size=(n, 2)).astype(np.float32)
    default = np.asarray([0.5, 0.25, 0.125, 2.0], np.float32)
    ref = np.asarray(jtex.sample_texture(jbank, jnp.asarray(ids),
                                         jnp.asarray(uv),
                                         default=jnp.asarray(default)))
    got = ttex.sample_texture(bank, torch.tensor(ids), torch.tensor(uv),
                              default=torch.tensor(default)).numpy()
    nearest = np.isin(ids, [0, 1, 2, 3])
    np.testing.assert_array_equal(got[nearest], ref[nearest])
    np.testing.assert_array_equal(got[ids < 0], np.tile(default,
                                                        ((ids < 0).sum(), 1)))
    np.testing.assert_allclose(got, ref, rtol=0.0, atol=1e-6)


def test_sample_texture_keeps_leading_shape(banks):
    _, jbank, bank = banks
    rng = np.random.default_rng(31)
    ids = rng.integers(0, 8, size=(6, 5)).astype(np.int32)
    uv = rng.uniform(size=(6, 5, 2)).astype(np.float32)
    got = ttex.sample_texture(bank, torch.tensor(ids), torch.tensor(uv))
    ref = np.asarray(jtex.sample_texture(jbank, jnp.asarray(ids),
                                         jnp.asarray(uv)))
    assert got.shape == (6, 5, 4)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0.0, atol=1e-6)


def test_v_is_flipped_and_nearest_rounds_half_to_even():
    """A 2 x 2 texture read by hand: v = 0 is the image's bottom row, and a
    uv on a texel centre + half a texel (x = 0.5, 1.5: ties) rounds to the
    even texel."""
    img = np.asarray([[[1.0], [2.0]], [[3.0], [4.0]]], np.float32)
    bank = ttex.TextureBank.build(
        [{"image": img, "filter": ttex.FILTER_NONE,
          "wrap_u": ttex.WRAP_CLAMP, "wrap_v": ttex.WRAP_CLAMP}], device="cpu")
    ids = torch.zeros(4, dtype=torch.int32)
    uv = torch.tensor([[0.1, 0.1], [0.9, 0.1], [0.1, 0.9], [0.9, 0.9]])
    np.testing.assert_array_equal(
        ttex.sample_texture(bank, ids, uv)[:, 0].numpy(), [3.0, 4.0, 1.0, 2.0])
    # u·2 − 0.5 = 0.5 → 0 (even), 1.5 → 2 → clamped to 1.
    uv = torch.tensor([[0.5, 0.9], [1.0, 0.9]])
    np.testing.assert_array_equal(
        ttex.sample_texture(bank, ids[:2], uv)[:, 0].numpy(), [1.0, 2.0])


def test_wrap_coord_matches_jax():
    i = np.arange(-20, 21, dtype=np.int32)
    for n in (1, 2, 7):
        for mode in (ttex.WRAP_CLAMP, ttex.WRAP_REPEAT):
            ref = np.asarray(jtex._wrap_coord(jnp.asarray(i), n, mode))
            got = ttex._wrap_coord(torch.tensor(i).long(), torch.tensor(n),
                                   torch.tensor(mode)).numpy()
            np.testing.assert_array_equal(got, ref)


def test_unorm_helpers_match_jax():
    x = np.linspace(-0.2, 1.2, 1001, dtype=np.float32)
    g8 = ttex.unorm8_encode(torch.tensor(x))
    np.testing.assert_array_equal(g8.numpy(),
                                  np.asarray(jtex.unorm8_encode(x)))
    np.testing.assert_allclose(ttex.unorm8_decode(g8).numpy(),
                               np.asarray(jtex.unorm8_decode(
                                   jtex.unorm8_encode(x))), rtol=1e-7)
    g16 = ttex.unorm16_encode(torch.tensor(x))
    np.testing.assert_array_equal(
        g16.numpy(), np.asarray(jtex.unorm16_encode(x)).astype(np.int32))
    np.testing.assert_allclose(ttex.unorm16_decode(g16).numpy(),
                               np.asarray(jtex.unorm16_decode(
                                   jtex.unorm16_encode(x))), rtol=1e-7)
