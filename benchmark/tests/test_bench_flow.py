"""Each traffic through a whole run at a tiny size on the CPU (the port's
plain paths), with the timed path broken underneath so that ``correct``
comes out false; the control against the limits; the roofline's counts;
the profile readers; and, on a card, a short run of every cell."""

import contextlib
import io
import json
import math
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark.harness import cli, faults, profiling, roofline, spec

from benchmark.tests.conftest import program_fault, with_pending

MEASURED = [w["name"] for w in spec.load_benchmark()["workloads"]]
WORKLOADS = with_pending()["workloads"]
CELLS = [w["name"] for w in WORKLOADS]
RENDER_CELLS = [w["name"] for w in WORKLOADS if w["traffic"] == "render"]
JOBS = {c: spec.resolve(c, with_pending()).traffic["job"] for c in CELLS}
SEED = 3000000019


def _run(cell: str, trace: int = 0) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(time.perf_counter(),
                      ["--workload", cell, "--seed", str(SEED), "--seconds",
                       "0.5", "--trace", str(trace)],
                      device=torch.device("cpu"))
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_traffic_runs_on_the_cpu(tiny_cells, cell):
    result = _run(cell)
    assert list(result)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in result
    if program_fault(cell):
        # The check catches the program's recorded fault: a cell that
        # proves correct here is ready for BENCHMARK.json.
        assert result["correct"] is False
        assert any(math.isnan(c["value"]) for c in result["checks"].values())
    else:
        assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    want = {m["name"] for m in spec.resolve(cell).end_to_end}
    assert set(result["metrics"]) == want
    for m in result["metrics"].values():
        assert m["value"] >= 0 and m["unit"]


@pytest.mark.parametrize("cell, fault", [
    (c, f) for c in CELLS for f in sorted(faults.FAULTS[JOBS[c]])])
def test_fault_makes_correct_false(tiny_cells, monkeypatch, cell, fault):
    faults.plant(JOBS[cell], fault, monkeypatch.setattr)
    assert _run(cell)["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(tiny_cells, cell):
    """The reference in bfloat16 in the program's place reads above the
    cell's limit on at least one number."""
    c = spec.resolve(cell)
    job = spec.job_module(c.traffic)
    state = job.setup(c, SEED, torch.device("cpu"), time.perf_counter())
    out = job.calibrate(state, SEED, control=True)
    limits = c.checks["limits"]
    assert all(out["program"][k] <= v for k, v in limits.items()) is (
        program_fault(cell) is None)
    assert any(out["control"][k] > v for k, v in limits.items())


@pytest.mark.parametrize("cell", RENDER_CELLS)
def test_roofline_counts_repeat(tiny_cells, cell):
    from benchmark.reference import render as ref
    from benchmark.reference.scene import raw_scene
    c = spec.resolve(cell)
    tables = ref.build_tables(raw_scene(c.config), torch.device("cpu"))
    job = spec.job_module(c.traffic)
    poses = job.orbit_poses(c.config["camera"], c.traffic["orbit"])
    counts = []
    for _ in range(2):
        rng = np.random.default_rng(SEED)
        pixels = torch.as_tensor(np.sort(rng.choice(256, 32, replace=False)))
        got = {}
        ref.render_pixels(tables, ref.Settings(), ref.camera(poses[3], 16, 16,
                                                            "cpu"),
                          16, 16, pixels, 2, counts=got)
        counts.append(got)
    assert counts[0] == counts[1]
    assert counts[0]["traces"] >= counts[0]["shaded"] > 0
    flops, n_bytes = roofline.frame_work(counts[0], 64, 256, tables.n_tris,
                                         3, False, False, 1000)
    assert flops > 0 and n_bytes == 1000 + 256 * 12
    assert roofline.query_flops(34) == 2 * 6 * 24 + 2 * 50


def test_segment_readers():
    E = profiling.Event
    seg = profiling.Segment(
        device=[E("mesh_megakernel_kernel<1>", 0, 40), E("Memset (Device)",
                                                         30, 50),
                E("Memcpy DtoH", 80, 90)],
        spans=[E("bench.job", 0, 100), E("bench.post", 50, 80)],
        start_ns=0, end_ns=100)
    assert seg.launches() == 2
    assert seg.busy_s() == 60e-9
    assert seg.device_s("mesh_megakernel") == 40e-9
    b = seg.breakdown()
    assert b["idle_gaps"][0] == ["bench.post", 30e-9]
    reading = {"segment": seg, "jobs": 1, "accumulations": 2,
               "least_time_per_frame_s": 4e-9, "post_ms": [1.0, 3.0],
               "scene_build_s": 0.5}
    read = lambda name: spec.metric_reader(name).read(reading)  # noqa: E731
    assert read("megakernel_roofline_pct") == pytest.approx(20.0)
    assert read("launches_per_sample") == 1.0
    assert read("post_ms") == 2.0
    assert read("device_idle_pct.render") == pytest.approx(40.0)
    assert read("scene_build_s") == 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("cell", MEASURED)
def test_cell_on_the_card(card, cell):
    """``benchmark/run.py`` as the benchmark's check starts it."""
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=spec.ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
