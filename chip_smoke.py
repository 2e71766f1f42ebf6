#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero before the last
line):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 is switched off for matmuls and convolutions.
2. build: compiles the dense trace kernel (csrc/dense_intersect.cu) with
   nvcc into build/kernels/.
3. kernel: the kernel against its plain PyTorch version on the card, on
   65,536 random rays (numpy seed 0) against the CornellBox soup (rays
   from the room's free space) and a ~16k-triangle sphere + floor soup
   (rays from around the sphere): closest hit with t_max = inf, with a
   finite t_max, and with a live prefix of R/3. prim must agree on
   >= 99.9% of rays and t be allclose (rtol 1e-5) where it does. Median
   times by CUDA events.
4. slice: CornellBox 512², 4 bounces, 8 accumulations through
   render_progressive; the trace kernel's launch count must rise, the
   image be finite and lit. One accumulation with the trace forced to the
   plain version must pass the statistical gate of
   tests/test_pallas_mesh.py:25-42 against the kernel's. The frame is
   tonemapped and written to build/cornell_512.png; frame time, rays/s
   and peak memory are printed.

Then one JSON line of per-kernel results, and last the JSON result line.
The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
R = 65536
RES = 512
ACCUMULATIONS = 8
BOUNCES = 4


def check(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {message}")


def device_phase() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "measures the port on a CUDA card only", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi)
    print(f"device: {torch.cuda.get_device_name(0)} | torch {torch.__version__}"
          f" | cuda {torch.version.cuda} | matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    return smi


def build_phase() -> float:
    from bifrost3d_tpu_torch.utils import cuda_build
    t0 = time.perf_counter()
    path = cuda_build.build("dense_intersect.cu")
    seconds = time.perf_counter() - t0
    with open(os.path.splitext(path)[0] + ".log") as f:
        ptxas = " ".join(line.strip() for line in f
                         if "registers" in line or "spill" in line)
    print(f"build: dense_intersect.cu in {seconds:.2f} s -> "
          f"{os.path.relpath(path, REPO)} | {ptxas}", flush=True)
    return seconds


def _soups(device):
    from bifrost3d_tpu_torch.apps.scenes import create_cornell_box
    from bifrost3d_tpu_torch.geometry.creation import make_plane, make_sphere
    from bifrost3d_tpu_torch.geometry.mesh import transform_mesh
    cornell = create_cornell_box(device=device)[0].tri_verts
    sphere = make_sphere(radius=0.5, slices=128, stacks=64)
    floor = transform_mesh(make_plane(size=4.0), np.asarray(
        [[1, 0, 0, 0], [0, 1, 0, -0.5], [0, 0, 1, 0]], np.float32))
    soup = np.concatenate([m.positions[m.indices] for m in (sphere, floor)])
    return {"cornell": cornell,
            "sphere": torch.tensor(soup, dtype=torch.float32, device=device)}


def _rays(rng, name, device):
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if name == "cornell":
        # In the room's free space above both boxes: a ray starting inside
        # a box would see the box's bottom face coplanar with the floor, a
        # tie that FMA contraction resolves either way.
        o = rng.uniform((-0.45, 0.12, -0.45), (0.45, 0.45, 0.45),
                        size=(R, 3)).astype(np.float32)
    else:                   # around the sphere, aimed near its centre
        o = rng.normal(size=(R, 3)).astype(np.float32)
        o = 1.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
        aim = -o + rng.normal(scale=0.4, size=(R, 3)).astype(np.float32)
        d = aim / np.linalg.norm(aim, axis=-1, keepdims=True)
    t_max = rng.uniform(0.2, 1.5, size=R).astype(np.float32)
    return [torch.tensor(a, device=device) for a in (o, d, t_max)]


def _median_ms(fn, repeats=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def kernel_phase(device) -> dict:
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense
    rng = np.random.default_rng(0)
    results, failures = {}, []
    for name, tris in _soups(device).items():
        comp, n = dense.pack_triangles(tris)
        o, d, t_max = _rays(rng, name, device)
        worst_err, worst_agree = 0.0, 1.0
        for case, bound, live in (("inf", float("inf"), None),
                                  ("t_max", t_max, None),
                                  ("live", float("inf"), R // 3)):
            got = dense.dense_intersect_cuda(comp, n, o, d, 1e-4, bound, live)
            ref = dense.dense_intersect_reference(comp, n, o, d, 1e-4, bound,
                                                  live)
            torch.cuda.synchronize()
            rows = slice(None) if live is None else slice(0, live)
            agree = got.prim[rows] == ref.prim[rows]
            frac = float(agree.float().mean())
            if frac < 0.999:
                failures.append(f"{name}/{case}: prim agrees on {frac:.5f}")
            if live is not None and not bool((got.prim[live:] == -1).all()):
                failures.append(f"{name}/{case}: rays past n_live must miss")
            hit = agree & (ref.prim[rows] >= 0)
            tg, tr = got.t[rows][hit], ref.t[rows][hit]
            if not bool(torch.allclose(tg, tr, rtol=1e-5, atol=0.0)):
                failures.append(f"{name}/{case}: t differs beyond rtol 1e-5")
            err = float((tg - tr).abs().max()) if tg.numel() else 0.0
            worst_err = max(worst_err, err)
            worst_agree = min(worst_agree, frac)
            hits = float((ref.prim[rows] >= 0).float().mean())
        ms = _median_ms(lambda: dense.dense_intersect_cuda(
            comp, n, o, d, 1e-4, float("inf")))
        plain_ms = _median_ms(lambda: dense.dense_intersect_reference(
            comp, n, o, d, 1e-4, float("inf")))
        results[name] = dict(n_tris=n, max_abs_err=worst_err, ms=ms,
                             plain_ms=plain_ms, agree=worst_agree)
        print(f"kernel/{name}: {R} rays x {n} tris | prim agrees >= "
              f"{worst_agree:.5f} | max |dt| {worst_err:.3g} | hit share "
              f"(live case) {hits:.3f} | kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms (median of 20)", flush=True)
    check(not failures, "; ".join(failures))
    return results


def _gate(img, ref, flip_budget=0.03) -> float:
    d = (img - ref).abs().amax(dim=-1)
    flips = float((d > 1e-3).float().mean())
    check(flips < flip_budget, f"{flips:.4f} of pixels differ by > 1e-3")
    mi, mr = float(img.mean()), float(ref.mean())
    check(abs(mi - mr) < 0.02 * max(mr, 1e-3), f"means {mi} vs {mr}")
    return flips


def slice_phase(device) -> dict:
    from bifrost3d_tpu_torch.apps.scenes import create_cornell_box
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    from bifrost3d_tpu_torch.io.image import save_image
    from bifrost3d_tpu_torch.post.pipeline import process
    from bifrost3d_tpu_torch.post.tonemap import CameraEffectsSettings

    scene, cam = create_cornell_box(device=device)
    settings = pt.RenderSettings(max_bounce_count=BOUNCES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    dense.reset_launch_count()
    t0 = time.perf_counter()
    hdr = pt.render_progressive(scene, cam, RES, RES, ACCUMULATIONS, settings)
    torch.cuda.synchronize()
    progressive_s = time.perf_counter() - t0
    launches = dense.launch_count
    check(launches > 0, "the main path launched no trace kernel")
    check(hdr.shape == (RES, RES, 3), f"image shape {tuple(hdr.shape)}")
    check(bool(torch.isfinite(hdr).all()), "image is not finite")
    mean = float(hdr.mean())
    check(mean > 0.05, f"image mean {mean} is not lit")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # One accumulation, kernel trace vs the plain version of the trace.
    kern = pt.render_sample_pooled(scene, cam, RES, RES, 0, settings)
    with mock.patch.object(dense, "pallas_intersect",
                           dense.dense_intersect_reference):
        plain = pt.render_sample_pooled(scene, cam, RES, RES, 0, settings)
    flips = _gate(kern, plain)

    # Frame time and in-run ray rate of one pooled accumulation.
    frame_ms, rates = [], []
    for acc in (1, 2, 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, rays = pt.render_sample_pooled_counted(scene, cam, RES, RES, acc,
                                                  settings)
        rays = int(rays)   # synchronises
        dt = time.perf_counter() - t0
        frame_ms.append(dt * 1e3)
        rates.append(rays / dt)

    ldr = process(hdr, CameraEffectsSettings.preset()._replace(film_grain=0.0))
    png = os.path.join(REPO, "build", "cornell_512.png")
    os.makedirs(os.path.dirname(png), exist_ok=True)
    save_image(png, ldr)
    check(os.path.getsize(png) > 0, "PNG not written")

    out = dict(launches=launches, mean=mean, flips=flips,
               progressive_s=progressive_s,
               frame_ms=statistics.median(frame_ms),
               rays_per_s=statistics.median(rates), peak_gib=peak_gib,
               png=os.path.relpath(png, REPO))
    print(f"slice: CornellBox {RES}x{RES} {BOUNCES} bounces x{ACCUMULATIONS} "
          f"in {progressive_s:.2f} s | trace launches {launches} | mean "
          f"{mean:.4f} | gate vs plain trace: {flips:.4f} flips | frame "
          f"{out['frame_ms']:.1f} ms, {out['rays_per_s'] / 1e6:.2f} M rays/s "
          f"(median of 3) | peak {peak_gib:.3f} GiB | {out['png']}",
          flush=True)
    return out


def main() -> int:
    device_phase()
    device = torch.device("cuda", 0)
    build_phase()
    kernels = kernel_phase(device)
    sliced = slice_phase(device)
    cornell = kernels["cornell"]
    print(json.dumps({"kernels": [{
        "name": "dense_intersect",
        "route": "cuda",
        "source": "bifrost3d_tpu_torch/csrc/dense_intersect.cu",
        "replaces": "bifrost3d_tpu/geometry/pallas_intersect.py:74",
        "launches": sliced["launches"],
        "max_abs_err": max(k["max_abs_err"] for k in kernels.values()),
        "ms": cornell["ms"],
        "plain_ms": cornell["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
