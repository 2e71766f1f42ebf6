#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases (each prints one or more lines; any failure exits non-zero before
the last line):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 is switched off for matmuls and convolutions.
2. build: compiles both kernels (csrc/dense_intersect.cu and
   csrc/mesh_megakernel.cu) with nvcc into build/kernels/, one nvcc each,
   started together; prints each build's time and ptxas report.
3. rng: the megakernel's path_rng_4d (megakernel_rng_probe) must equal the
   port's torch path_rng_4d bit for bit on 65,536 seeded (pixel hash,
   dimension) pairs at accumulations 0, 1 and 7.
4. kernel: the dense trace kernel against its plain PyTorch version on the
   card, on 65,536 random rays (numpy seed 0) against the CornellBox soup
   (rays from the room's free space) and a ~16k-triangle sphere + floor
   soup (rays from around the sphere): closest hit with t_max = inf, with
   a finite t_max, and with a live prefix of R/3. prim must agree on
   >= 99.9% of rays and t be allclose (rtol 1e-5) where it does. Median
   times by CUDA events.
5. wavefront: CornellBox 512², 4 bounces, one accumulation through
   render_sample_pooled, the path of scenes the megakernel does not take;
   the trace kernel's launch count must rise. One accumulation with the
   trace forced to the plain version must pass the statistical gate of
   tests/test_pallas_mesh.py:25-42 against the kernel's; pooled frame
   time and rays/s are printed.
6. megakernel: CornellBox and SphereLight at 512² and Veach, Veach
   mesh-light and the coated, spot-light, Default+Diffuse, emissive and
   directional-light test scenes at 256², 4 bounces, one accumulation
   each: the kernel against its plain version on the same inputs (the
   same RNG bits, only FMA contraction differs: at most 0.2% of pixels off
   by > 1e-3, means within 0.5%) and against the pooled wavefront (the
   statistical gate: 3%, 2%), ray counts within 2% of the wavefront's. For
   CornellBox and SphereLight also the median kernel and plain times (CUDA
   events) and the frame time and rays/s of render_sample_fast.
7. progressive: CornellBox 512² × 8 accumulations through
   render_progressive, the main path: the megakernel's launch count must
   rise by exactly 8, the image be finite and lit; it is tonemapped and
   written to build/cornell_512.png; time and peak memory are printed.

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
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
R = 65536
RES = 512
SMALL_RES = 256
ACCUMULATIONS = 8
BOUNCES = 4
SOURCES = ("dense_intersect.cu", "mesh_megakernel.cu")
# Kernel vs its plain version on the same inputs: share of pixels off by
# > 1e-3, and relative difference of the means.
KERNEL_FLIPS, KERNEL_MEAN = 0.002, 0.005


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


def build_phase() -> None:
    from bifrost3d_tpu_torch.utils import cuda_build

    def build(source):
        t0 = time.perf_counter()
        path = cuda_build.build(source)
        return path, time.perf_counter() - t0

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = list(pool.map(build, SOURCES))
    for source, (path, seconds) in zip(SOURCES, built):
        with open(os.path.splitext(path)[0] + ".log") as f:
            ptxas = " ".join(line.strip() for line in f
                             if "registers" in line or "spill" in line)
        print(f"build: {source} in {seconds:.2f} s -> "
              f"{os.path.relpath(path, REPO)} | {ptxas}", flush=True)


def rng_phase(device) -> None:
    from bifrost3d_tpu_torch.integrator import pallas_mesh as mega
    from bifrost3d_tpu_torch.sampling.sobol import path_rng_4d
    rng = np.random.default_rng(1)
    hashes = torch.tensor(rng.integers(0, 2**32, R), device=device)
    dims = torch.tensor(rng.integers(0, 64, R), device=device)
    for acc in (0, 1, 7):
        got = mega.rng_probe(acc, hashes, dims)
        ref = path_rng_4d(acc, hashes, dims)
        torch.cuda.synchronize()
        same = int((got.view(torch.int32) == ref.view(torch.int32)).sum())
        check(same == got.numel(), f"rng at accumulation {acc}: "
              f"{got.numel() - same} of {got.numel()} values differ")
    print(f"rng: megakernel path_rng_4d bit-exact with the torch chain on "
          f"{R} (pixel hash, dimension) pairs x 4 at accumulations 0, 1, 7",
          flush=True)


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


def _gate(img, ref, what, flip_budget=0.03, mean_budget=0.02):
    """The statistical gate of tests/test_pallas_mesh.py:25-42 → (share of
    pixels off by > 1e-3, max |difference|, relative difference of the
    means)."""
    d = (img - ref).abs().amax(dim=-1)
    flips = float((d > 1e-3).float().mean())
    check(bool(torch.isfinite(img).all()), f"{what}: image is not finite")
    check(flips < flip_budget, f"{what}: {flips:.4f} of pixels differ by "
          "> 1e-3")
    mi, mr = float(img.mean()), float(ref.mean())
    rel = abs(mi - mr) / max(mr, 1e-3)
    check(rel < mean_budget, f"{what}: means {mi} vs {mr}")
    return flips, float(d.max()), rel


def _reset_counts():
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense
    from bifrost3d_tpu_torch.integrator import pallas_mesh as mega
    dense.reset_launch_count()
    mega.reset_launch_count()


def slice_phase(device) -> dict:
    from bifrost3d_tpu_torch.apps.scenes import create_cornell_box
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense
    from bifrost3d_tpu_torch.integrator import path_tracer as pt

    scene, cam = create_cornell_box(device=device)
    settings = pt.RenderSettings(max_bounce_count=BOUNCES)
    torch.cuda.synchronize()

    # The wavefront path, driven with every count at 0.
    _reset_counts()
    kern = pt.render_sample_pooled(scene, cam, RES, RES, 0, settings)
    torch.cuda.synchronize()
    launches = dense.launch_count
    check(launches > 0, "the wavefront path launched no trace kernel")
    mean = float(kern.mean())
    check(mean > 0.05, f"image mean {mean} is not lit")

    # One accumulation, kernel trace vs the plain version of the trace.
    with mock.patch.object(dense, "pallas_intersect",
                           dense.dense_intersect_reference):
        plain = pt.render_sample_pooled(scene, cam, RES, RES, 0, settings)
    flips, _, _ = _gate(kern, plain, "wavefront vs plain trace")

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

    out = dict(launches=launches, mean=mean, flips=flips,
               frame_ms=statistics.median(frame_ms),
               rays_per_s=statistics.median(rates))
    print(f"wavefront: CornellBox {RES}x{RES} {BOUNCES} bounces pooled | "
          f"trace launches {launches} | mean {mean:.4f} | gate vs plain "
          f"trace: {flips:.4f} flips | frame {out['frame_ms']:.1f} ms, "
          f"{out['rays_per_s'] / 1e6:.2f} M rays/s (median of 3)",
          flush=True)
    return out


def _megakernel_scenes(device):
    from bifrost3d_tpu_torch.apps import scenes
    yield "CornellBox", RES, scenes.create_cornell_box(device=device)
    yield "SphereLight", RES, scenes.create_sphere_light_scene(device=device)
    yield "Veach", SMALL_RES, scenes.create_veach_scene(device=device)
    yield "Veach mesh-light", SMALL_RES, scenes.create_veach_scene(
        with_mesh_light=True, device=device)
    for name, build in scenes.TEST_SCENES.items():
        yield name, SMALL_RES, build(device=device)


def megakernel_phase(device) -> dict:
    from bifrost3d_tpu_torch.integrator import pallas_mesh as mega
    from bifrost3d_tpu_torch.integrator import path_tracer as pt

    results = {}
    for name, res, (scene, cam) in _megakernel_scenes(device):
        settings = pt.RenderSettings(max_bounce_count=BOUNCES)
        path = pt.explain_render_path(scene, settings)
        check(path == "megakernel", f"{name}: {path}")
        args = mega.megakernel_inputs(scene, cam, res, res, 1, settings)
        got = mega.mesh_megakernel_cuda(*args)
        ref = mega.mesh_megakernel_reference(*args)
        torch.cuda.synchronize()
        img = torch.stack(got[:3], dim=-1)
        flips, max_err, mean_rel = _gate(
            img, torch.stack(ref[:3], dim=-1), f"{name}: kernel vs plain",
            KERNEL_FLIPS, KERNEL_MEAN)
        rays = float(got[3].sum())
        pooled, pooled_rays = pt.render_sample_pooled_counted(
            scene, cam, res, res, 1, settings)
        wf_flips, _, _ = _gate(img.reshape(res, res, 3), pooled,
                               f"{name}: kernel vs wavefront")
        pooled_rays = int(pooled_rays)
        check(abs(rays - pooled_rays) <= 0.02 * pooled_rays,
              f"{name}: {rays} rays vs the wavefront's {pooled_rays}")
        out = dict(res=res, n_tris=int(scene.tri_verts.shape[0]),
                   flips=flips, max_abs_err=max_err, mean_rel=mean_rel,
                   wavefront_flips=wf_flips,
                   rays=rays, wavefront_rays=pooled_rays,
                   mean=float(img.mean()))
        line = (f"megakernel/{name}: {res}x{res} {out['n_tris']} tris | vs "
                f"plain {flips:.5f} flips, max |d| {max_err:.3g}, means "
                f"{mean_rel:.2e} apart | vs "
                f"wavefront {wf_flips:.4f} flips | rays {rays:.0f} vs "
                f"{pooled_rays} | mean {out['mean']:.4f}")
        if name in ("CornellBox", "SphereLight"):
            out["ms"] = _median_ms(lambda: mega.mesh_megakernel_cuda(*args),
                                   repeats=10, warmup=2)
            out["plain_ms"] = _median_ms(
                lambda: mega.mesh_megakernel_reference(*args), repeats=3,
                warmup=1)
            frame_ms, rates = [], []
            for acc in (1, 2, 3, 4, 5):
                _, acc_rays = mega.render_mesh_megakernel(
                    scene, cam, res, res, acc, settings)
                acc_rays = float(acc_rays)   # synchronises
                t0 = time.perf_counter()
                pt.render_sample_fast(scene, cam, res, res, acc, settings)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                frame_ms.append(dt * 1e3)
                rates.append(acc_rays / dt)
            out["frame_ms"] = statistics.median(frame_ms)
            out["rays_per_s"] = statistics.median(rates)
            line += (f" | kernel {out['ms']:.3f} ms, plain "
                     f"{out['plain_ms']:.1f} ms (CUDA events) | "
                     f"render_sample_fast frame {out['frame_ms']:.2f} ms, "
                     f"{out['rays_per_s'] / 1e6:.1f} M rays/s (median of 5)")
        print(line, flush=True)
        results[name] = out
    return results


def progressive_phase(device) -> dict:
    from bifrost3d_tpu_torch.apps.scenes import create_cornell_box
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense
    from bifrost3d_tpu_torch.integrator import pallas_mesh as mega
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    from bifrost3d_tpu_torch.io.image import save_image
    from bifrost3d_tpu_torch.post.pipeline import process
    from bifrost3d_tpu_torch.post.tonemap import CameraEffectsSettings

    scene, cam = create_cornell_box(device=device)
    settings = pt.RenderSettings(max_bounce_count=BOUNCES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # The main path, driven with every count at 0.
    _reset_counts()
    t0 = time.perf_counter()
    hdr = pt.render_progressive(scene, cam, RES, RES, ACCUMULATIONS, settings)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, trace_launches = mega.launch_count, dense.launch_count
    check(launches == ACCUMULATIONS, f"the main path launched the "
          f"megakernel {launches} times for {ACCUMULATIONS} frames")
    check(hdr.shape == (RES, RES, 3), f"image shape {tuple(hdr.shape)}")
    check(bool(torch.isfinite(hdr).all()), "image is not finite")
    mean = float(hdr.mean())
    check(mean > 0.05, f"image mean {mean} is not lit")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    ldr = process(hdr, CameraEffectsSettings.preset()._replace(film_grain=0.0))
    png = os.path.join(REPO, "build", "cornell_512.png")
    os.makedirs(os.path.dirname(png), exist_ok=True)
    save_image(png, ldr)
    check(os.path.getsize(png) > 0, "PNG not written")
    print(f"progressive: CornellBox {RES}x{RES} {BOUNCES} bounces "
          f"x{ACCUMULATIONS} through render_progressive in {seconds:.3f} s | "
          f"megakernel launches {launches}, trace launches {trace_launches} "
          f"| mean {mean:.4f} | peak {peak_gib:.3f} GiB | "
          f"{os.path.relpath(png, REPO)}", flush=True)
    return dict(launches=launches, seconds=seconds, mean=mean,
                peak_gib=peak_gib)


def main() -> int:
    device_phase()
    device = torch.device("cuda", 0)
    build_phase()
    rng_phase(device)
    kernels = kernel_phase(device)
    sliced = slice_phase(device)
    scenes = megakernel_phase(device)
    main = progressive_phase(device)
    cornell, mega = kernels["cornell"], scenes["CornellBox"]
    print(json.dumps({"kernels": [{
        "name": "dense_intersect",
        "route": "cuda",
        "source": "bifrost3d_tpu_torch/csrc/dense_intersect.cu",
        "replaces": "bifrost3d_tpu/geometry/pallas_intersect.py:74",
        "launches": sliced["launches"],
        "max_abs_err": max(k["max_abs_err"] for k in kernels.values()),
        "ms": cornell["ms"],
        "plain_ms": cornell["plain_ms"],
    }, {
        "name": "mesh_megakernel",
        "route": "cuda",
        "source": "bifrost3d_tpu_torch/csrc/mesh_megakernel.cu",
        "replaces": "bifrost3d_tpu/integrator/pallas_mesh.py:1541",
        "launches": main["launches"],
        "max_abs_err": mega["max_abs_err"],
        "flip_share": max(s["flips"] for s in scenes.values()),
        "ms": mega["ms"],
        "plain_ms": mega["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
