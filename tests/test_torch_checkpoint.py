"""Checkpoints (utils/checkpoint.py) across the two packages, and the
profiling helpers (utils/profiling.py), on the CPU.

A checkpoint written by the JAX package loads into the port with
``like``, and one written by the port loads into the JAX package with
``like``: the leaf names (dict keys sorted, NamedTuple fields, sequence
indices, ``<root>``), the arrays bit for bit, the dtypes, ``step`` and the
metadata. A template of another structure raises JAX's errors.
"""

import os
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifrost3d_tpu.utils import checkpoint as jckpt

from bifrost3d_tpu_torch.utils import checkpoint as tckpt
from bifrost3d_tpu_torch.utils import profiling
import torch_parity  # noqa: F401  (one torch thread per worker)

NAMES = ["buffer", "count", "state/a", "state/b/0", "state/b/1",
         "state/c/x", "zeta"]


class State(NamedTuple):
    a: object
    b: object
    c: object


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        buffer=rng.random((4, 5, 3)).astype(np.float32),
        count=np.int32(7),
        a=rng.integers(0, 1 << 30, size=(6,)).astype(np.uint32),
        b0=(rng.random(3) > 0.5),
        b1=rng.random((2, 2)).astype(np.float64),
        x=rng.integers(-5, 5, size=(3,)).astype(np.int64),
        zeta=np.float32(0.25))


def _tree(arrays, lift):
    return {"zeta": lift(arrays["zeta"]), "buffer": lift(arrays["buffer"]),
            "none": None, "count": lift(arrays["count"]),
            "state": State(a=lift(arrays["a"]),
                           b=[lift(arrays["b0"]), lift(arrays["b1"])],
                           c={"x": lift(arrays["x"])})}


def _torch(a):
    return torch.tensor(a.astype(np.int64) if a.dtype == np.uint32 else a)


def _leaves_in_order(tree):
    return [tree["buffer"], tree["count"], tree["state"].a,
            tree["state"].b[0], tree["state"].b[1], tree["state"].c["x"],
            tree["zeta"]]


def test_jax_writes_port_loads(tmp_path):
    arrays = _arrays(1)
    path = str(tmp_path / "ckpt_3.npz")
    jckpt.save_checkpoint(path, _tree(arrays, jnp.asarray), step=3,
                          metadata={"scene": "CornellBox"})
    like = _tree(_arrays(2), _torch)
    tree, step, meta = tckpt.load_checkpoint(path, like=like)
    assert step == 3 and meta == {"scene": "CornellBox"}
    assert tree["none"] is None and isinstance(tree["state"], State)
    flat, _, _ = tckpt.load_checkpoint(path)
    assert list(flat) == NAMES
    stored, _, _ = jckpt.load_checkpoint(path)
    for got, want, template in zip(_leaves_in_order(tree), stored.values(),
                                   _leaves_in_order(like)):
        assert got.dtype == template.dtype
        np.testing.assert_array_equal(got.numpy(), want.astype(
            got.numpy().dtype))


def test_port_writes_jax_loads(tmp_path):
    arrays = _arrays(3)
    path = str(tmp_path / "ckpt_5.npz")
    assert tckpt.save_checkpoint(path, _tree(arrays, _torch), step=5,
                                 metadata={"scene": "Sphere", "n": 5}) == path
    assert not os.path.exists(path + ".tmp")
    like = _tree(_arrays(4), jnp.asarray)
    tree, step, meta = jckpt.load_checkpoint(path, like=like)
    assert step == 5 and meta == {"scene": "Sphere", "n": 5}
    for got, want in zip(_leaves_in_order(tree),
                         _leaves_in_order(_tree(arrays, _torch))):
        np.testing.assert_array_equal(np.asarray(got), want.numpy().astype(
            np.asarray(got).dtype))
    flat, _, _ = jckpt.load_checkpoint(path)
    assert list(flat) == NAMES
    with np.load(path) as data:
        assert sorted(data.files) == sorted(
            [f"leaf_{i}" for i in range(len(NAMES))] + ["__checkpoint_meta__"])
        assert data["leaf_0"].dtype == np.float32


def test_bare_leaf_is_root(tmp_path):
    path = str(tmp_path / "x.npz")
    tckpt.save_checkpoint(path, torch.arange(4, dtype=torch.float32))
    flat, step, meta = jckpt.load_checkpoint(path)
    assert list(flat) == ["<root>"] and step is None and meta == {}
    tree, _, _ = tckpt.load_checkpoint(path, like=torch.zeros(4))
    torch.testing.assert_close(tree, torch.arange(4, dtype=torch.float32))


@pytest.mark.parametrize("like, message", [
    ({"buffer": 0, "extra": 0}, "checkpoint has 1 leaves, template has 2"),
    ({"other": 0}, "leaf mismatch: checkpoint 'buffer' vs template 'other'"),
])
def test_mismatch_raises_as_jax(tmp_path, like, message):
    path = str(tmp_path / "ckpt_1.npz")
    tckpt.save_checkpoint(path, {"buffer": torch.zeros(2)}, step=1)
    for load, lift in ((tckpt.load_checkpoint, torch.tensor),
                       (jckpt.load_checkpoint, jnp.asarray)):
        with pytest.raises(ValueError) as err:
            load(path, like={k: lift(v) for k, v in like.items()})
        assert str(err.value) == message


def test_latest_checkpoint(tmp_path):
    assert tckpt.latest_checkpoint(str(tmp_path / "missing")) is None
    for name in ("ckpt_4.npz", "ckpt_12.npz", "ckpt_x.npz", "other_99.npz",
                 "ckpt_7.npz.tmp"):
        (tmp_path / name).write_bytes(b"")
    got = tckpt.latest_checkpoint(str(tmp_path))
    assert got == jckpt.latest_checkpoint(str(tmp_path))
    assert got == str(tmp_path / "ckpt_12.npz")


def test_stage_timings_and_frame_timer():
    timings = profiling.StageTimings()
    x = torch.ones(8)
    for _ in range(3):
        with timings.scope("trace", x, {"y": [x]}):
            x = x * 2
    total, count = timings.timings()["trace"]
    assert count == 3 and total >= 0.0
    assert "trace" in timings.report().splitlines()[1]
    timings.reset()
    assert timings.timings() == {}
    timer = profiling.FrameTimer(window=4)
    assert timer.fps == 0.0
    for t in range(6):
        timer.tick(now=0.5 * t)
    assert timer.fps == pytest.approx(2.0)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(str(tmp_path / "trace")):
        timings = profiling.StageTimings()
        with timings.scope("matmul"):
            torch.ones(16, 16) @ torch.ones(16, 16)
    text = (tmp_path / "trace" / "trace.json").read_text()
    assert "traceEvents" in text and "matmul" in text
