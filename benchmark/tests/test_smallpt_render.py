"""The SmallPT reference (``reference/smallpt.py``) against the port's
plain estimator and against the independent float64 witness, and the
SmallPT roofline's counts, on the CPU."""

import os

import numpy as np
import pytest
import torch

from benchmark.harness import roofline, roofline_smallpt, spec
from benchmark.reference import smallpt as ref

CONFIG = spec._json(os.path.join(spec.BENCH_DIR, "configs", "smallpt.json"))
SEED = 3000000019


def _at(width, height):
    return dict(CONFIG, width=width, height=height)


def test_reference_is_the_ports_plain_estimator():
    """Each lane's radiance equals the port's
    ``render_smallpt_accumulation`` at 16 x 12, accumulations 1-4, within
    1e-6 relative (the same float32 operations in the same order: bit for
    bit on this CPU)."""
    from bifrost3d_tpu_torch.integrator.smallpt import (
        render_smallpt_accumulation)
    from bifrost3d_tpu_torch.scene.spheres import smallpt_scene
    torch.set_num_threads(2)
    w, h = 16, 12
    cfg = _at(w, h)
    scene = smallpt_scene(device=torch.device("cpu"))
    sph, st = ref.spheres(cfg, "cpu"), ref.settings(cfg)
    px = torch.arange(w * h)
    for n in range(1, 5):
        want = render_smallpt_accumulation(scene, w, h, n).reshape(-1, 3)
        got = ref.radiance(sph, st, px % w, px // w, w, h,
                           torch.full((w * h,), n))
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        assert float(want.amax()) > 0.0
    # The running mean lerps them in the app's order.
    mean = torch.zeros((w * h, 3))
    for n in range(1, 5):
        frame = render_smallpt_accumulation(scene, w, h, n).reshape(-1, 3)
        mean = mean + (frame - mean) / n
    torch.testing.assert_close(ref.render_pixels(cfg, px, 4), mean,
                               rtol=1e-6, atol=1e-6)


def test_reference_mean_agrees_with_the_float64_witness():
    """At 64 x 48 x 32 the image mean is within 3% of
    ``tests/smallpt_reference.py``, the float64 numpy estimator written
    against smallpt's own intersection (t-min 1e-4, rays starting on the
    surface): the same seeds and draws, so the two agree on most paths,
    and the departures (t-min 1e-2, a 0.05 origin offset, float32) move
    the paths they touch, not the estimate's expectation. The band is the
    JAX package's own against the same witness (tests/test_smallpt.py);
    on an x86 CPU the two means read 0.39098 and 0.39089 (0.03% apart)
    and 81.9% of the pixels lie within 2%."""
    torch.set_num_threads(2)
    witness = spec.load_module(os.path.join(spec.ROOT, "tests",
                                            "smallpt_reference.py"),
                               "smallpt_float64_witness")
    w, h, n = 64, 48, 32
    got = ref.render_pixels(_at(w, h), torch.arange(w * h), n)
    want = witness.render(w, h, n).reshape(-1, 3)
    assert abs(float(got.mean()) / want.mean() - 1.0) < 0.03
    # Most pixels are near-identical (test_smallpt.py's second gate).
    rel = np.abs(got.double().numpy() - want).max(axis=-1) / (
        want.max(axis=-1) + 1e-2)
    assert np.mean(rel < 0.02) > 0.80


def test_roofline_counts_repeat():
    cfg = _at(16, 16)
    counts = []
    for _ in range(2):
        rng = np.random.default_rng(SEED)
        pixels = torch.as_tensor(np.sort(rng.choice(256, 32, replace=False)))
        got = {}
        ref.render_pixels(cfg, pixels, 2, counts=got)
        counts.append(got)
    assert counts[0] == counts[1]
    # Every lane enters its first bounce; none more than max_depth.
    assert 64 <= counts[0]["bounces"] <= 64 * CONFIG["max_depth"]
    flops, n_bytes = roofline_smallpt.frame_work(counts[0]["bounces"], 64,
                                                 256, 9)
    assert flops == pytest.approx(counts[0]["bounces"] * 4 * (9 * 30 + 120))
    assert n_bytes == 9 * 44 + 256 * 24 + 4
    # 1024 x 768 at PERF.md's 5,167,593 bounces: bound by operations.
    t = roofline.least_time_s(*roofline_smallpt.frame_work(5167593, 786432,
                                                            786432, 9))
    assert t == pytest.approx(5167593 * 390 / 67e12)
