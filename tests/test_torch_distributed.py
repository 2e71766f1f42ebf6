"""The port's multi-process wiring (``parallel/distributed.py``) on the CPU.

A real 2-process gloo group, in subprocesses that import the port only
(``run_selftest``): each process renders its rows of a SmallPT frame and
of a CornellBox frame over the global mesh of 2 processes × 2 shards,
all-reduces a checksum and a sharded gradient, and process 0 holds the
gathered frames and the gradient against one process's render (SmallPT
and CornellBox within 1e-5, the gradient within atol 1e-5 and rtol 2e-3:
JAX's self-test gates). Every process has its own time limit, so a hung
rank fails the test instead of stalling the suite. Then the host-local
bookkeeping and the world-size-1 renders in this process.
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per test worker)
from bifrost3d_tpu_torch.apps.scenes import create_cornell_box
from bifrost3d_tpu_torch.integrator import path_tracer as tpt
from bifrost3d_tpu_torch.integrator.smallpt import render_smallpt_accumulation
from bifrost3d_tpu_torch.parallel import distributed as dd
from bifrost3d_tpu_torch.scene.spheres import smallpt_scene

CPU = torch.device("cpu")


def test_two_process_gloo_selftest():
    report = dd.run_selftest(num_processes=2, devices_per_process=2,
                             timeout=240.0, device="cpu")
    assert "backend=gloo processes=2 mesh=4" in report, report


def test_selftest_kills_a_rank_past_its_time_limit():
    """A rank still running at its time limit is killed and the self-test
    fails (here every rank: none can join a group within 0.5 s)."""
    with pytest.raises(RuntimeError, match="killed after 0.5 s"):
        dd.run_selftest(num_processes=2, devices_per_process=1, timeout=0.5,
                        device="cpu")


def test_shard_rows_local():
    assert dd.shard_rows_local([CPU] * 8, 40) == (0, 40)
    mesh = dd.GlobalMesh([CPU] * 2, process_index=1, process_count=3)
    assert mesh.size == 6
    assert dd.shard_rows_local(mesh, 36) == (12, 24)
    with pytest.raises(ValueError, match="do not divide"):
        dd.shard_rows_local(mesh, 37)


def test_global_rows_round_trip():
    mesh = dd.global_render_mesh([CPU] * 4)
    assert mesh.process_count == 1 and mesh.process_index == 0
    local = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    rows = dd.make_global_rows(mesh, local, 16)
    assert len(rows.blocks) == 4 and rows.start == 0
    np.testing.assert_array_equal(dd.gather_rows(rows), local)
    with pytest.raises(ValueError, match="holds rows"):
        dd.make_global_rows(dd.GlobalMesh([CPU], 1, 2), local, 16)


def test_multihost_render_at_world_size_one():
    scene, cam = create_cornell_box(device="cpu")
    settings = tpt.settings_for_scene(scene, max_bounce_count=2)
    mesh = dd.global_render_mesh([CPU] * 3)
    rows = dd.make_multihost_render(mesh, 16, 16, settings)(scene, cam, 1)
    assert rows.global_rows == 18
    frame = dd.gather_rows(rows)[:16]
    ref, _ = tpt.render_pixels_pooled(scene, cam, 16, 16, 1, settings)
    np.testing.assert_array_equal(frame, ref.reshape(16, 16, 3).numpy())


def test_multihost_smallpt_at_world_size_one():
    scene = smallpt_scene(device="cpu")
    mesh = dd.global_render_mesh([CPU] * 4)
    rows = dd.make_multihost_smallpt(mesh, 16, 13)(scene, 2)
    frame = dd.gather_rows(rows)[:13]
    np.testing.assert_array_equal(
        frame, render_smallpt_accumulation(scene, 16, 13, 2).numpy())
    assert dd.process_count() == 1 and not dd.is_initialized()
