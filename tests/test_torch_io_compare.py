"""Image comparison of the port (``io/compare``: rms, ssim, mssim) against
the JAX package's on seeded images.

Each function returns a Python float, and JAX's ``rms`` and ``ssim`` call
``float()`` inside, so they cannot be jitted and ``assert_f64_anchored``
(which runs JAX jitted too) does not apply. The same anchoring is made
here by hand: the port's float64 run equals JAX's float64 run (under
``jax.enable_x64`` with ``jnp.float32`` mapped to float64, as
``assert_f64_anchored`` does) to rtol 1e-9, and each package's float32
run is within 1e-5 of that value, relative: a float32 mean over the
image's 3,072 pixels is good to a few ulps of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifrost3d_tpu.io import compare as jcompare

from bifrost3d_tpu_torch.io import compare as tcompare
import torch_parity  # noqa: F401  (one torch thread per test worker)


def _images(seed, noise):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:48, 0:64]
    ref = np.stack([np.sin(xx / 7.0), np.cos(yy / 5.0), (xx + yy) / 112.0],
                   -1) * 0.4 + 0.5
    target = ref + rng.normal(0, noise, ref.shape)
    return ref, target


def _jax64(fn, *args):
    f32 = jnp.float32
    try:
        jnp.float32 = jnp.float64
        with jax.enable_x64(True):
            return fn(*(jnp.asarray(a, jnp.float64) for a in args))
    finally:
        jnp.float32 = f32


@pytest.mark.parametrize("noise", [0.0, 0.01, 0.2])
@pytest.mark.parametrize("name", ["rms", "ssim", "mssim"])
def test_compare_matches_jax(name, noise):
    port, ref_fn = getattr(tcompare, name), getattr(jcompare, name)
    a, b = _images(3, noise)
    anchor = _jax64(ref_fn, a, b)
    got64 = port(a, b)
    assert abs(got64 - anchor) <= 1e-9 * abs(anchor) + 1e-15, (got64, anchor)
    a32, b32 = a.astype(np.float32), b.astype(np.float32)
    for value in (port(a32, b32), port(torch.tensor(a32), torch.tensor(b32)),
                  ref_fn(a32, b32)):
        assert isinstance(value, float)
        assert abs(value - anchor) <= 1e-5 * abs(anchor) + 1e-7, (
            value, anchor)


def test_identical_images_score_one():
    a, _ = _images(0, 0.0)
    a = a.astype(np.float32)
    assert tcompare.rms(a, a) == 0.0
    for fn in (tcompare.ssim, tcompare.mssim):
        assert fn(a, a) == pytest.approx(1.0, abs=1e-6)


def test_mssim_window_has_the_positive_exponent():
    """The reference's window weight grows with distance (Compare.h:158-160),
    and so the port's: a target that differs only in a corner scores the
    same in both."""
    a, _ = _images(1, 0.0)
    b = a.copy()
    b[:4, :4] += 0.3
    got, ref = tcompare.mssim(a, b), jcompare.mssim(a, b)
    assert got < 1.0
    assert got == pytest.approx(ref, rel=1e-6)
