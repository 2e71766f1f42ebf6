"""What every traffic's run shares: the closed loop of the measured window
and the traced segment.

A traffic's job module supplies one job (``run(k)``, the ``k``-th job of
the window, returning what the check would keep of it) and its spans;
this module times the jobs, keeps one of them for the check, prints the
set-up's parts on standard error, and runs the traced segment between
two spin kernels.
"""

from __future__ import annotations

import sys
import time

import torch

from benchmark.harness import profiling


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(s, seconds: float, run) -> tuple:
    """Jobs ``run(0)``, ``run(1)``, ... back to back until ``seconds`` have
    passed; the job in flight then finishes. What one job returns, drawn
    uniformly from ``s.rng`` (a reservoir of one), is kept in ``s.kept``
    for the check. Sets ``s.setup_s`` (process start to the first timed
    job) and ``s.jobs_done`` → (jobs, elapsed seconds, each job's
    seconds)."""
    latencies = []
    start = time.perf_counter()
    s.setup_s = start - s.t0
    k = 0
    while k == 0 or time.perf_counter() - start < seconds:
        t = time.perf_counter()
        out = run(k)
        latencies.append(time.perf_counter() - t)
        if s.rng.random() * (k + 1) < 1.0:
            s.kept = out
        k += 1
    elapsed = time.perf_counter() - start
    s.jobs_done = k
    print("setup parts: " + ", ".join(f"{n} {v:.3f}" for n, v in
                                      s.setup_parts.items()),
          file=sys.stderr, flush=True)
    return k, elapsed, latencies


def traced(device, run) -> profiling.Segment | None:
    """``run()`` under torch.profiler between two spin kernels → the traced
    segment (None where the card's trace was lost). The program's counters
    are read just before the session opens and just after it closes, so
    reading them adds no time to the segment."""
    from torch.profiler import ProfilerActivity, profile
    sync(device)
    before = profiling.program_counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiling.spin()
        run()
        profiling.spin()
        sync(device)
    # A counter first seen after the session counts from 0.
    counters = {k: v - before.get(k, 0)
                for k, v in profiling.program_counters().items()}
    return profiling.segment(prof, counters)


def device_reading(seg) -> dict:
    """The traced segment's device numbers that every traffic reports."""
    return {"segment": seg,
            "busy_s": seg.busy_s() if seg else 0.0,
            "window_s": seg.window_s if seg else 0.0,
            "breakdown": seg.breakdown() if seg else None}
