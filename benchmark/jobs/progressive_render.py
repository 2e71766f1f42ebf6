"""The viewer's progressive render, as a closed loop of one user.

A job is what a SimpleViewer user waits for after moving the camera: the
camera on an orbit around the scene's own target at the scene's distance,
``render_progressive`` over the traffic's accumulations (on a card the
mesh megakernel, one launch a frame and no host synchronise), the post
chain with the viewer's tonemapper, and the LDR image on the host. Jobs
run back to back.

The orbit's poses are a fixed set; the seed draws only their order and
which job is checked, so every seed's window holds the same mix of work.
"""

from __future__ import annotations

import math
import statistics
import time

import numpy as np
import torch

from benchmark.harness import loop, program, roofline
from benchmark.reference import render as ref
from benchmark.reference.scene import raw_scene


def orbit_poses(camera: dict, orbit: dict) -> list:
    """``orbit["poses"]`` cameras around ``camera``'s target at its
    distance: yaw and pitch (degrees) spread over the orbit's ranges, the
    pitch in a fixed scrambled order."""
    eye = np.asarray(camera["eye"], np.float64)
    target = np.asarray(camera["target"], np.float64)
    offset = eye - target
    dist = np.linalg.norm(offset)
    yaw0 = math.atan2(offset[0], offset[2])
    pitch0 = math.asin(offset[1] / dist)
    n = int(orbit["poses"])
    (ylo, yhi), (plo, phi) = orbit["yaw_degrees"], orbit["pitch_degrees"]
    poses = []
    for i in range(n):
        yaw = yaw0 + math.radians(ylo + (yhi - ylo) * (i + 0.5) / n)
        pitch = pitch0 + math.radians(
            plo + (phi - plo) * ((i * 5 % n) + 0.5) / n)
        off = dist * np.asarray([math.cos(pitch) * math.sin(yaw),
                                 math.sin(pitch),
                                 math.cos(pitch) * math.cos(yaw)])
        poses.append({"eye": [float(v) for v in target + off],
                      "target": [float(v) for v in target],
                      "fov_radians": camera["fov_radians"]})
    return poses


class State:
    """One run's program and what it produced."""

    def __init__(self, cell, seed: int, device, t0: float):
        cfg, traffic = cell.config, cell.traffic
        self.cell, self.device, self.t0 = cell, device, t0
        self.rng = np.random.default_rng(seed)
        self.width, self.height = int(cfg["width"]), int(cfg["height"])
        self.accumulations = int(traffic["accumulations"])
        self.tonemapper = cfg["tonemapper"]
        self.raw = raw_scene(cfg)
        self.poses = orbit_poses(cfg["camera"], traffic["orbit"])
        self.order = self.rng.permutation(len(self.poses))
        self.jobs_done = 0
        self.kept = None          # (pose index, HDR on the device, LDR host)
        self.setup_s = None
        self.scene_build_s = None
        self.setup_parts = {}

    def pose(self, k: int) -> int:
        return int(self.order[k % len(self.order)])


def setup(cell, seed: int, device, t0: float) -> State:
    from bifrost3d_tpu_torch.integrator.path_tracer import render_progressive
    from bifrost3d_tpu_torch.post.pipeline import process
    from bifrost3d_tpu_torch.post.tonemap import CameraEffectsSettings

    s = State(cell, seed, device, t0)
    t = time.perf_counter()
    s.setup_parts["imports_s"] = t - t0
    s.scene = program.build_scene(s.raw, device)
    loop.sync(device)
    s.scene_build_s = time.perf_counter() - t
    s.setup_parts["scene_build_s"] = s.scene_build_s
    s.settings = program.render_settings(s.scene, cell.config["max_bounces"])
    s.cameras = [program.camera(p, s.width, s.height, device)
                 for p in s.poses]
    s.post = CameraEffectsSettings.preset()._replace(
        tonemapping_mode=ref.TONEMAPPERS.index(s.tonemapper), film_grain=0.0)
    s.render_progressive, s.process = render_progressive, process
    t = time.perf_counter()
    _job(s, s.pose(0))            # the warm-up job: builds and loads it all
    s.setup_parts["warm_up_job_s"] = time.perf_counter() - t
    return s


def _job(s: State, pose: int):
    """One job → (HDR on the device, LDR on the host)."""
    hdr = s.render_progressive(s.scene, s.cameras[pose], s.width, s.height,
                               s.accumulations, s.settings)
    ldr = s.process(hdr, s.post)
    return hdr, ldr.cpu()


def window(s: State, seconds: float) -> dict:
    """The closed loop over the seed's order of poses."""
    def run(k):
        pose = s.pose(k)
        return (pose,) + _job(s, pose)
    k, elapsed, latencies = loop.closed_loop(s, seconds, run)
    samples = k * s.width * s.height * s.accumulations
    p95 = (statistics.quantiles(latencies, n=20)[18]
           if len(latencies) > 1 else latencies[0])
    return {"attempted": k, "failed": 0,
            "metrics": {"samples_per_s": samples / elapsed,
                        "image_p95_ms": p95 * 1e3,
                        "setup_s": s.setup_s}}


def trace(s: State) -> dict:
    """``trace_jobs`` more jobs under torch.profiler, run as the window
    runs them (spans mark the render's enqueue, the post and the
    readback); then as many jobs outside it, each post timed by the host's
    clock between synchronises; then the reference's path counts on a
    seeded sample of each traced pose, for the roofline."""
    from torch.profiler import record_function
    n = int(s.cell.traffic["trace_jobs"])
    poses = [s.pose(s.jobs_done + i) for i in range(n)]

    def run():
        for pose in poses:
            with record_function("bench.job"):
                with record_function("bench.render"):
                    hdr = s.render_progressive(
                        s.scene, s.cameras[pose], s.width, s.height,
                        s.accumulations, s.settings)
                with record_function("bench.post"):
                    ldr = s.process(hdr, s.post)
                with record_function("bench.readback"):
                    ldr.cpu()
    seg = loop.traced(s.device, run)
    post_ms = []
    for pose in poses:
        hdr = s.render_progressive(s.scene, s.cameras[pose], s.width,
                                   s.height, s.accumulations, s.settings)
        loop.sync(s.device)
        t = time.perf_counter()
        s.process(hdr, s.post)
        loop.sync(s.device)
        post_ms.append((time.perf_counter() - t) * 1e3)
    return {**loop.device_reading(seg), "jobs": n,
            "accumulations": s.accumulations, "post_ms": post_ms,
            "scene_build_s": s.scene_build_s,
            "least_time_per_frame_s": _frame_least_time(s, poses)}


def _frame_least_time(s: State, poses: list) -> float:
    """The least time of one frame's work, averaged over ``poses``: the
    reference's path counts on ``roofline_pixels`` seeded pixels ×
    ``roofline_accumulations`` accumulations of each pose."""
    traffic = s.cell.traffic
    n_px, n_acc = int(traffic["roofline_pixels"]), int(
        traffic["roofline_accumulations"])
    frame = s.width * s.height
    tables = ref.build_tables(s.raw, s.device)
    settings = _ref_settings(s)
    table_bytes = 4 * (tables.tri.numel() + 19 * tables.n_tris
                       + tables.mats.numel() + tables.lights.numel()
                       + tables.texels.numel() + 2 * 32 * 32)
    extras = any(tr >= 0 for tr in tables.mat_tex)
    rng = np.random.default_rng(int(s.rng.integers(2**63)))
    total = 0.0
    for pose in poses:
        pixels = torch.as_tensor(np.sort(rng.choice(frame, n_px, replace=False)),
                                 device=s.device)
        counts = {}
        with torch.no_grad():
            ref.render_pixels(tables, settings,
                              ref.camera(s.poses[pose], s.width, s.height,
                                         s.device),
                              s.width, s.height, pixels, n_acc,
                              counts=counts)
        flops, n_bytes = roofline.frame_work(
            counts, n_px * n_acc, frame, tables.n_tris, settings.ris_count,
            tables.has_coat, extras, table_bytes)
        total += roofline.least_time_s(flops, n_bytes)
    return total / len(poses)


def _ref_settings(s: State) -> ref.Settings:
    """The configuration's bounces; the rest ``RenderSettings``' defaults."""
    return ref.Settings(max_bounce=int(s.cell.config["max_bounces"]))


def compare(prog_hdr, ref_hdr, prog_ldr, ref_ldr) -> dict:
    """The numbers compared: of the sampled pixels' HDR, per pixel the
    largest relative difference over its channels (against the
    reference's value, or 0.01 where that is smaller), its share above
    1e-3 and its median; of the whole LDR image, the largest absolute
    difference."""
    rel = ((prog_hdr - ref_hdr).abs()
           / ref_hdr.abs().clamp_min(0.01)).amax(dim=-1)
    return {
        "hdr_off_share": float((rel > 1e-3).float().mean()),
        "hdr_median_rel": float(rel.median()),
        "ldr_max_abs": float((prog_ldr - ref_ldr).abs().max()),
    }


def reference_outputs(s: State, pose: int, hdr, dtype=torch.float32):
    """The reference's HDR at the check's seeded pixels of job ``pose`` and
    its post of the program's whole HDR image → (pixels, ref HDR [n, 3],
    ref LDR [h, w, 3]); ``dtype`` below float32 makes the control."""
    n_px = int(s.cell.checks["pixels"])
    frame = s.width * s.height
    pixels = torch.as_tensor(
        np.sort(s.rng.choice(frame, min(n_px, frame), replace=False)),
        device=hdr.device)
    tables = ref.build_tables(s.raw, hdr.device)
    cam = ref.camera(s.poses[pose], s.width, s.height, hdr.device)
    with torch.no_grad():
        ref_hdr = ref.render_pixels(tables, _ref_settings(s), cam, s.width,
                                    s.height, pixels, s.accumulations,
                                    dtype=dtype)
        ref_ldr = ref.post(hdr, s.tonemapper, dtype=dtype)
    return pixels, ref_hdr, ref_ldr


def check(s: State) -> dict:
    """The kept job against the reference, after the program's state is
    freed → {name: (value, limit)}."""
    pose, hdr, ldr = s.kept
    for name in ("scene", "cameras", "settings"):
        setattr(s, name, None)
    if s.device.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pixels, ref_hdr, ref_ldr = reference_outputs(s, pose, hdr)
    numbers = compare(hdr.reshape(-1, 3)[pixels], ref_hdr,
                      ldr.to(hdr.device), ref_ldr)
    limits = s.cell.checks["limits"]
    return {name: (numbers[name], float(limits[name])) for name in limits}


def calibrate(s: State, seed: int, control: bool) -> dict:
    """The check's numbers for one more job of seed ``seed`` (its first
    pose, the timed path at the timed size) and, with ``control``, those
    of the control: the reference in the program's place with its frames,
    running mean and post in bfloat16."""
    s.rng = np.random.default_rng(seed)
    s.order = s.rng.permutation(len(s.poses))
    pose = s.pose(0)
    hdr, ldr = _job(s, pose)
    out = {"pose": pose}
    t = time.perf_counter()
    pixels, ref_hdr, ref_ldr = reference_outputs(s, pose, hdr)
    out["reference_s"] = time.perf_counter() - t
    out["program"] = compare(hdr.reshape(-1, 3)[pixels], ref_hdr,
                             ldr.to(hdr.device), ref_ldr)
    if control:
        tables = ref.build_tables(s.raw, hdr.device)
        cam = ref.camera(s.poses[pose], s.width, s.height, hdr.device)
        with torch.no_grad():
            low = ref.render_pixels(tables, _ref_settings(s), cam, s.width,
                                    s.height, pixels, s.accumulations,
                                    dtype=torch.bfloat16)
            low_ldr = ref.post(hdr, s.tonemapper, dtype=torch.bfloat16)
        out["control"] = compare(low, ref_hdr, low_ldr, ref_ldr)
    return out
