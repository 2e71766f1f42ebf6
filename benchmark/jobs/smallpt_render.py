"""SmallPT's progressive render, as a closed loop of one user.

A job is what a user of the SmallPT app waits for: the app's own
``render_progressive`` over the traffic's accumulations, a fresh running
mean of accumulations 1 .. n as ``smallpt_app -n <n>`` renders it (on a
card the SmallPT megakernel, one launch and one memset a frame, the lerp
in the kernel), and the float32 HDR running mean on the host, as the app
reads it back before saving. Jobs run back to back.

SmallPT's camera is fixed, so every job does the same work; the seed draws
only which job is checked and which pixels are compared.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import loop, roofline, roofline_smallpt
from benchmark.reference import smallpt as ref


class State:
    """One run's program and what it produced."""

    def __init__(self, cell, seed: int, device, t0: float):
        cfg, traffic = cell.config, cell.traffic
        self.cell, self.device, self.t0 = cell, device, t0
        self.rng = np.random.default_rng(seed)
        self.width, self.height = int(cfg["width"]), int(cfg["height"])
        self.accumulations = int(traffic["accumulations"])
        self.jobs_done = 0
        self.kept = None          # the HDR running mean on the device
        self.setup_s = None
        self.scene_build_s = None
        self.setup_parts = {}


def setup(cell, seed: int, device, t0: float) -> State:
    from bifrost3d_tpu_torch.apps import smallpt_app

    s = State(cell, seed, device, t0)
    t = time.perf_counter()
    s.setup_parts["imports_s"] = t - t0
    # The app's scene, built once through its own cache (keyed as
    # render_progressive keys it), so the jobs find it and its tables.
    smallpt_app._scene(torch.device(device), False)
    loop.sync(device)
    s.scene_build_s = time.perf_counter() - t
    s.setup_parts["scene_build_s"] = s.scene_build_s
    s.render_progressive = smallpt_app.render_progressive
    t = time.perf_counter()
    _job(s)                       # the warm-up job: builds and loads it all
    s.setup_parts["warm_up_job_s"] = time.perf_counter() - t
    return s


def _render(s: State):
    return s.render_progressive(s.width, s.height, s.accumulations,
                                quiet=True, device=s.device)


def _job(s: State):
    """One job: the render and its readback → the HDR running mean
    [height, width, 3] on the device. The host copy is dropped at once: a
    host copy kept for the check would hold 9.4 MB of the heap wherever
    the seed's draw left it, and the next jobs' copies would page-fault
    by how the heap then lies, so that the seed moved the rate."""
    hdr = _render(s)
    hdr.cpu()
    return hdr


def window(s: State, seconds: float) -> dict:
    k, elapsed, _ = loop.closed_loop(s, seconds, lambda k: _job(s))
    samples = k * s.width * s.height * s.accumulations
    return {"attempted": k, "failed": 0,
            "metrics": {"samples_per_s": samples / elapsed,
                        "setup_s": s.setup_s}}


def trace(s: State) -> dict:
    """``trace_jobs`` more jobs under torch.profiler, run as the window
    runs them (spans mark the render and the readback); then the
    reference's bounce count on a seeded sample, for the roofline."""
    from torch.profiler import record_function
    n = int(s.cell.traffic["trace_jobs"])

    def run():
        for _ in range(n):
            with record_function("bench.job"):
                with record_function("bench.render"):
                    hdr = _render(s)
                with record_function("bench.readback"):
                    hdr.cpu()
    seg = loop.traced(s.device, run)
    return {**loop.device_reading(seg), "jobs": n,
            "accumulations": s.accumulations,
            "scene_build_s": s.scene_build_s,
            "least_time_per_frame_s": _frame_least_time(s)}


def _frame_least_time(s: State) -> float:
    """The least time of one frame's work: the reference's bounces on
    ``roofline_pixels`` seeded pixels × the first ``roofline_accumulations``
    accumulations, scaled to the frame."""
    traffic = s.cell.traffic
    n_px, n_acc = int(traffic["roofline_pixels"]), int(
        traffic["roofline_accumulations"])
    frame = s.width * s.height
    rng = np.random.default_rng(int(s.rng.integers(2**63)))
    pixels = torch.as_tensor(np.sort(rng.choice(frame, min(n_px, frame),
                                                replace=False)),
                             device=s.device)
    counts = {}
    with torch.no_grad():
        ref.render_pixels(s.cell.config, pixels, n_acc, counts=counts)
    return roofline.least_time_s(*roofline_smallpt.frame_work(
        counts["bounces"], pixels.numel() * n_acc, frame,
        len(s.cell.config["spheres"])))


def compare(prog_hdr, ref_hdr) -> dict:
    """The numbers compared, over the sampled pixels: per pixel the largest
    relative difference over its channels (against the reference's value,
    or 0.01 where that is smaller), its share above 1e-3 and its median;
    and the relative difference of the pixels' mean radiance."""
    rel = ((prog_hdr - ref_hdr).abs()
           / ref_hdr.abs().clamp_min(0.01)).amax(dim=-1)
    ref_mean = float(ref_hdr.mean())
    return {
        "hdr_off_share": float((rel > 1e-3).float().mean()),
        "hdr_median_rel": float(rel.median()),
        "image_mean_rel": abs(float(prog_hdr.mean()) - ref_mean) / ref_mean,
    }


def reference_hdr(s: State):
    """The check's seeded pixels and the reference's running mean of them
    → (pixels on the device, ref HDR [n, 3])."""
    n_px = int(s.cell.checks["pixels"])
    frame = s.width * s.height
    pixels = torch.as_tensor(
        np.sort(s.rng.choice(frame, min(n_px, frame), replace=False)),
        device=s.device)
    with torch.no_grad():
        out = ref.render_pixels(s.cell.config, pixels, s.accumulations)
    return pixels, out


def check(s: State) -> dict:
    """The kept job against the reference → {name: (value, limit)}."""
    if s.device.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pixels, ref_hdr = reference_hdr(s)
    numbers = compare(s.kept.reshape(-1, 3)[pixels], ref_hdr)
    limits = s.cell.checks["limits"]
    return {name: (numbers[name], float(limits[name])) for name in limits}


def calibrate(s: State, seed: int, control: bool) -> dict:
    """The check's numbers for one more job, its pixels drawn from seed
    ``seed`` and, with ``control``, those of the control: the reference in
    the program's place with each path's state between bounces, its frames
    and its running mean in bfloat16."""
    s.rng = np.random.default_rng(seed)
    hdr = _job(s)
    out = {}
    t = time.perf_counter()
    pixels, ref_hdr = reference_hdr(s)
    out["reference_s"] = time.perf_counter() - t
    out["program"] = compare(hdr.reshape(-1, 3)[pixels], ref_hdr)
    if control:
        with torch.no_grad():
            low = ref.render_pixels(s.cell.config, pixels, s.accumulations,
                                    dtype=torch.bfloat16)
        out["control"] = compare(low, ref_hdr)
    return out
