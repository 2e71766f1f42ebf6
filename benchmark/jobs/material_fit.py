"""Inverse rendering: recover a scene's materials from an image, as a
closed loop of one user.

A job is one call of ``diff.render_grad.optimize_materials`` over the
configuration's scene and camera at its full size: Adam over the material
tints and roughnesses, fresh samples each step, ``settings_for_scene``
(remat on), from a start perturbed from the published materials, toward
the target image. The target is the published materials rendered by the
benchmark's reference, kept under ``benchmark/.cache/`` per configuration;
it does not depend on the seed. The starts are a fixed set drawn once from
the traffic's own seed; the run's seed draws their order and which job is
checked, so every seed's window holds the same work.

Each job's steps run through the window's own call; the check reads what
they produced: the frame each step rendered (kept as ``render_sample``
returns it, ``_recording_render``), the first gradient as the optimizer
gets it (``_RecordingAdam``), the losses, and the parameters after the
first ``reference_steps`` steps, which the reference follows from the
same start (a loss that is not a number at any step of the job fails the
check).
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import time

import numpy as np
import torch

from benchmark.harness import loop, program, spec
from benchmark.reference import fit as ref_fit
from benchmark.reference import render as ref
from benchmark.reference.scene import raw_scene

CACHE_DIR = os.path.join(spec.BENCH_DIR, ".cache")
# The fit's own domain: the clamps optimize_materials applies after every
# step, to the tints and to the roughnesses.
TINT_DOMAIN, ROUGHNESS_DOMAIN = (0.0, 1.0), (0.02, 1.0)
_ADAM = torch.optim.Adam


class _RecordingAdam(_ADAM):
    """``torch.optim.Adam`` that keeps, of each fit, the gradients of its
    first step as the optimizer gets them and the parameters after the
    steps the reference follows (as the next step starts from them)."""

    follow = 0
    grads = params = None

    def step(self, closure=None):
        n = getattr(self, "_steps", 0)
        self._steps = n + 1
        if n in (0, _RecordingAdam.follow):
            kept = [p.grad.detach().clone() if n == 0 else p.detach().clone()
                    for g in self.param_groups for p in g["params"]]
            if n == 0:
                _RecordingAdam.grads = kept
            else:
                _RecordingAdam.params = kept
        return super().step(closure)


def _recording_render(real, s):
    """``render_sample`` that keeps the first frames it returns in a job
    (without their autograd history) in ``s.frames``."""
    def render(*args, **kw):
        out = real(*args, **kw)
        if len(s.frames) < s.follow:
            s.frames.append(out.detach())
        return out
    return render


def starts(config: dict, traffic: dict) -> list:
    """The fixed set of (tint [m, 3], roughness [m]) starts: each published
    value moved by a uniform offset and held in the fit's own domain."""
    mats = ref.scene_mod.material_rows(raw_scene(config))
    rng = np.random.default_rng(int(traffic["start_seed"]))
    lo, hi = traffic["offset"]
    out = []
    for _ in range(int(traffic["starts"])):
        tint = np.clip(mats[:, 0:3] + rng.uniform(lo, hi, mats[:, 0:3].shape),
                       *TINT_DOMAIN).astype(np.float32)
        rough = np.clip(mats[:, 3] + rng.uniform(lo, hi, mats[:, 3].shape),
                        *ROUGHNESS_DOMAIN).astype(np.float32)
        out.append((tint, rough))
    return out


def target_image(cell, device) -> torch.Tensor:
    """The published materials rendered by the reference: the mean of
    ``target_accumulations`` wavefront frames (accumulations from 1000 on,
    apart from the fit's own), cached under ``benchmark/.cache/``."""
    cfg, traffic = cell.config, cell.traffic
    n = int(traffic["target_accumulations"])
    key = hashlib.sha256(json.dumps([cfg, n], sort_keys=True).encode()
                         ).hexdigest()[:16]
    path = os.path.join(CACHE_DIR, f"{cfg['name']}.fit_target.{key}.npy")
    if not os.path.exists(path):
        raw = raw_scene(cfg)
        tables = ref.build_tables(raw, device)
        w, h = int(cfg["width"]), int(cfg["height"])
        cam = ref.camera(cfg["camera"], w, h, device)
        settings = ref.Settings(max_bounce=int(cfg["max_bounces"]))
        img = torch.zeros((h, w, 3), device=device)
        with torch.no_grad():
            for k in range(n):
                img += ref_fit.frame(tables, settings, cam, w, h, 1000 + k,
                                     tables.mats[:, 0:3], tables.mats[:, 3])
        os.makedirs(CACHE_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            np.save(f, (img / n).cpu().numpy())
        os.replace(tmp, path)
    return torch.as_tensor(np.load(path), device=device)


class State:
    def __init__(self, cell, seed: int, device, t0: float):
        cfg, traffic = cell.config, cell.traffic
        self.cell, self.device, self.t0 = cell, device, t0
        self.rng = np.random.default_rng(seed)
        self.width, self.height = int(cfg["width"]), int(cfg["height"])
        self.steps = int(traffic["steps"])
        self.follow = min(int(traffic["reference_steps"]), self.steps)
        self.frames = []
        self.raw = raw_scene(cfg)
        self.starts = starts(cfg, traffic)
        self.order = self.rng.permutation(len(self.starts))
        self.jobs_done = 0
        self.kept = None
        self.setup_parts = {}

    def start(self, k: int) -> int:
        return int(self.order[k % len(self.order)])


def setup(cell, seed: int, device, t0: float) -> State:
    from bifrost3d_tpu_torch.diff import render_grad
    s = State(cell, seed, device, t0)
    t = time.perf_counter()
    s.setup_parts["imports_s"] = t - t0
    s.scene = program.build_scene(s.raw, device)
    loop.sync(device)
    s.scene_build_s = time.perf_counter() - t
    s.setup_parts["scene_build_s"] = s.scene_build_s
    s.settings = program.render_settings(s.scene,
                                         cell.config["max_bounces"])
    s.camera = program.camera(cell.config["camera"], s.width, s.height,
                              device)
    t = time.perf_counter()
    s.target = target_image(cell, device)
    s.setup_parts["target_s"] = time.perf_counter() - t
    mats = s.scene.materials
    s.start_scenes = [s.scene._replace(materials=mats._replace(
        tint=torch.tensor(tint, device=device),
        roughness=torch.tensor(rough, device=device)))
        for tint, rough in s.starts]
    s.optimize_materials = render_grad.optimize_materials
    # The recording stays in place from here to the check, so that what the
    # window's own calls produced is what is judged.
    s.real_render = render_grad.render_sample
    render_grad.render_sample = _recording_render(s.real_render, s)
    torch.optim.Adam = _RecordingAdam
    _RecordingAdam.follow = s.follow
    t = time.perf_counter()
    _job(s, s.start(0))           # the warm-up job
    s.setup_parts["warm_up_job_s"] = time.perf_counter() - t
    return s


def _stop_recording(s: State) -> None:
    from bifrost3d_tpu_torch.diff import render_grad
    torch.optim.Adam = _ADAM
    render_grad.render_sample = s.real_render


def _job(s: State, k: int):
    """One ``optimize_materials`` call from start ``k`` → (losses, first
    gradients, tint and roughness after the steps the reference follows,
    the first frames)."""
    s.frames, _RecordingAdam.params = [], None
    res = s.optimize_materials(
        s.start_scenes[k], s.camera, s.target, s.width, s.height,
        steps=s.steps, learning_rate=float(s.cell.traffic["learning_rate"]),
        spp=1, vary_samples=True, settings=s.settings)
    mats = res.scene.materials
    tint, rough = (_RecordingAdam.params if _RecordingAdam.params is not None
                   else (mats.tint, mats.roughness))
    return (res.losses, _RecordingAdam.grads, tint, rough, s.frames)


def window(s: State, seconds: float) -> dict:
    """The closed loop over the seed's order of starts."""
    if s.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(s.device)
    k, elapsed, _ = loop.closed_loop(
        s, seconds, lambda k: (s.start(k),) + _job(s, s.start(k)))
    peak = (torch.cuda.max_memory_allocated(s.device)
            if s.device.type == "cuda" else 0)
    return {"attempted": k, "failed": 0,
            "metrics": {"fit_steps_per_s": k * s.steps / elapsed,
                        "fit_peak_gib": peak / 2**30,
                        "setup_s": s.setup_s}}


def trace(s: State) -> dict:
    """``trace_jobs`` more jobs under torch.profiler, as the window runs
    them."""
    from torch.profiler import record_function
    n = int(s.cell.traffic["trace_jobs"])

    def run():
        for i in range(n):
            with record_function("bench.job"):
                _job(s, s.start(s.jobs_done + i))
    seg = loop.traced(s.device, run)
    return {**loop.device_reading(seg), "jobs": n, "steps": s.steps,
            "scene_build_s": s.scene_build_s}


def _gap(prog: list, want: list) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, against the reference's norm of that leaf or of the
    median leaf, whichever is larger."""
    norms = [float(torch.linalg.vector_norm(w)) for w in want]
    median = statistics.median(norms)
    return max(abs(float(torch.linalg.vector_norm(p)) - n) / max(n, median,
                                                                  1e-30)
               for p, n in zip(prog, norms))


def compare(prog: tuple, want: tuple, start: tuple) -> dict:
    """The numbers compared, program against reference: of the first
    step's frame (the start's parameters on both sides), per pixel the
    largest relative difference over its channels (against the
    reference's value, or 0.01 where that is smaller), its share above
    1e-3 and its median; each step's loss (the largest relative gap); the
    first gradient's norm and the norm of the parameters' change over the
    steps the reference follows (the worst leaf's gap). The later frames are judged through the
    losses and the change: after one Adam step a parameter whose gradient
    is all but zero moves by the learning rate either way on round-off,
    which moves the pixels it covers but neither loss nor norm."""
    (p_losses, p_grad, p_tint, p_rough, p_frames), (
        r_losses, r_grad, r_tint, r_rough, r_frames) = prog, want
    tint0, rough0 = start
    first = r_frames[0]
    rel = ((p_frames[0].to(first.device) - first).abs()
           / first.abs().clamp_min(0.01)).amax(dim=-1)
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(p_losses, r_losses))
    if any(map(np.isnan, p_losses)):
        loss_rel = float("nan")
    return {
        "image_off_share": float((rel > 1e-3).float().mean()),
        "image_median_rel": float(rel.median()),
        "loss_rel": loss_rel,
        "grad_norm_gap": _gap([g.to(r_grad[0].device) for g in p_grad],
                              list(r_grad)),
        "change_norm_gap": _gap(
            [p_tint.to(tint0.device) - tint0, p_rough.to(tint0.device)
             - rough0], [r_tint - tint0, r_rough - rough0]),
    }


def reference_job(s: State, k: int, device, dtype=torch.float32):
    """The reference's fit from start ``k`` over the job's first
    ``reference_steps`` steps → ((losses, first gradients, tint,
    roughness, frames), start)."""
    tables = ref.build_tables(s.raw, device)
    cam = ref.camera(s.cell.config["camera"], s.width, s.height, device)
    tint0, rough0 = (torch.tensor(a, device=device) for a in s.starts[k])
    out = ref_fit.optimize(
        tables, ref.Settings(max_bounce=int(s.cell.config["max_bounces"])),
        cam, target_image(s.cell, device), s.width, s.height, s.follow,
        tint0, rough0, float(s.cell.traffic["learning_rate"]), dtype=dtype)
    return out, (tint0, rough0)


def check(s: State) -> dict:
    k, losses, grad, tint, rough, frames = s.kept
    prog = (losses, grad, tint.detach(), rough.detach(), frames)
    _stop_recording(s)
    for name in ("scene", "start_scenes", "settings", "target"):
        setattr(s, name, None)
    if s.device.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    want, start = reference_job(s, k, s.device)
    numbers = compare(prog, want, start)
    limits = s.cell.checks["limits"]
    return {name: (numbers[name], float(limits[name])) for name in limits}


def calibrate(s: State, seed: int, control: bool) -> dict:
    """The check's numbers for one more job of seed ``seed`` (its first
    start) and, with ``control``, those of the control: the reference in
    the program's place with its frames and parameters in bfloat16."""
    s.rng = np.random.default_rng(seed)
    s.order = s.rng.permutation(len(s.starts))
    k = s.start(0)
    prog = _job(s, k)
    t = time.perf_counter()
    want, start = reference_job(s, k, s.device)
    norm = lambda xs: [float(torch.linalg.vector_norm(x)) for x in xs]  # noqa: E731
    out = {"start": k, "reference_s": time.perf_counter() - t,
           "losses": prog[0], "reference_losses": want[0],
           "grad_norms": [norm(prog[1]), norm(want[1])],
           "change_norms": [norm([prog[2].to(start[0].device) - start[0],
                                  prog[3].to(start[0].device) - start[1]]),
                            norm([want[2] - start[0], want[3] - start[1]])],
           "program": compare(prog, want, start)}
    if control:
        low, _ = reference_job(s, k, s.device, dtype=torch.bfloat16)
        out["control"] = compare(low, want, start)
    return out
