"""Fixtures of the benchmark's own tests (run with ``python -m pytest
benchmark/tests``; the card's cases with ``-m cuda`` on a machine with
one)."""

import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips where there is none)")


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this case runs the benchmark on the card")
    return torch.device("cuda", 0)


PENDING = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "pending_cells.json")


def with_pending() -> dict:
    """``BENCHMARK.json`` with the entries of ``pending_cells.json`` added:
    cells whose traffic, checks and readers are built but which are not
    measured yet (``PERF.md``, Open questions), run here on the CPU."""
    from benchmark.harness import spec
    bench = spec.load_benchmark()
    with open(PENDING) as f:
        pending = json.load(f)
    return {k: v + pending.get(k, []) if isinstance(v, list) else v
            for k, v in bench.items()}


def program_fault(cell: str) -> str | None:
    """The fault of the program that keeps a pending cell from proving
    correct, as ``pending_cells.json`` records it; None for other cells."""
    with open(PENDING) as f:
        return json.load(f).get("program_faults", {}).get(cell)


@pytest.fixture
def tiny_cells(monkeypatch):
    """``spec.resolve`` over ``with_pending()`` at a size the CPU holds
    (16 x 16 pixels, 2 accumulations, one traced job), and the port's
    dispatch sent to the megakernel's plain version, as on a card it
    would take the kernel."""
    from benchmark.harness import spec
    from bifrost3d_tpu_torch.integrator import path_tracer
    real = spec.resolve

    def tiny(name, bench=None, root=spec.ROOT):
        c = real(name, bench if bench is not None else with_pending(), root)
        return c._replace(
            config=dict(c.config, width=16, height=16),
            traffic=dict(c.traffic, accumulations=2, trace_jobs=1,
                         roofline_pixels=16, roofline_accumulations=1),
            checks=dict(c.checks, pixels=64))
    monkeypatch.setattr(spec, "resolve", tiny)
    monkeypatch.setattr(path_tracer, "_device_kind", lambda scene: "cuda")
    # The fit's set-up puts its recording in place for the rest of a run;
    # undone after each test.
    from bifrost3d_tpu_torch.diff import render_grad
    monkeypatch.setattr(render_grad, "render_sample", render_grad.render_sample)
    monkeypatch.setattr(torch.optim, "Adam", torch.optim.Adam)
    torch.set_num_threads(2)
    return tiny
