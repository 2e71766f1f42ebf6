"""Two trees of this repository on one CUDA card, in turns: the port's
kernels driven through the package's public entry points, timed, and their
outputs compared bit for bit.

Usage, from the root of this tree, with another commit unpacked into a
directory that ``.gitignore`` lists::

    git archive <commit> | tar -x -C build/parent
    python3 chip_compare.py build/parent

It builds both trees' kernels in parallel, then runs four turns (other,
this, this, other), each in a process of its own that imports its tree's
``bifrost3d_tpu_torch`` and calls the same workloads through functions
both trees export: B4, B1 on three tables (closest, bounded, live
prefix), B6 on two soups, B7 on the bridge's
camera and incoherent rays and on the 16,130-triangle soup's camera,
incoherent and surrounding rays (closest, bounded any-hit: its occlusion
and t, live prefix),
the gradient path's plain step (bench_backward's, CornellBox 256², 2
bounces; median of 5 after a first step, its tint gradient compared bit for
bit), the pooled wavefront's 512² CornellBox frame and its 512² frame of
hier_bridge_15k on B1 and on B6 (host clock, median of 3 after a first
frame). The benchmark's cells compare B2, B3, B5, the post chain and the
progressive loops of two commits (``BENCHMARK.json``), so they are not
here. For each workload one ``RESULT`` line per turn gives ``call_ms``,
the median time of the call between CUDA events, and ``kernel_ms``, the
device time per call of the kernels it launched other than torch's own
and memsets (torch.profiler), so a wrapper's host work and torch ops are
left out; ``nvidia-smi`` clocks, power draw and limit are printed beside
each group.
Then ``BITEQ`` says which workloads' outputs are bit-equal between the
trees, and between the two turns of each tree, and ``SUMMARY`` gives each
time of both turns of both trees. Timing helpers (``device_ms``: one
torch.profiler session per turn) and ray sets are chip_smoke.py's.

Last, ``LAUNCHES`` gives, for each tree in a process of its own, the CUDA
kernel launches of one pooled 512² CornellBox frame and of one plain train
step, counted by torch.profiler after a first of each: the launch calls on
the host, the kernels on the card, and both per wavefront iteration. The
counts do not depend on the host's load, so one run of each tree settles
them.

``python3 chip_compare.py --turn ROOT LABEL OUT.npz`` runs one turn;
``python3 chip_compare.py --launches ROOT`` counts one tree's launches.

``python3 chip_compare.py --pairs N OTHER`` times only the two host-bound
workloads, the pooled 512² Cornell frame and the plain train step, in 2N
processes a tree, in N rounds of other, this, this, other: each process
gives the median of 5 frames and of 5 steps after a first of each, and
``PAIRS`` gives every process's numbers and the medians of both trees.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def _smoke():
    """chip_smoke.py of this tree, for its helpers (its main does not run).
    Its yardstick (benchmark/harness/) is imported from this tree too, with
    this tree first on the path while it loads; the harness's profiling
    module imports ``SPAN_PREFIX`` and ``counters`` from the turn's
    ``bifrost3d_tpu_torch.utils.profiling``, so the other tree must export
    them."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    sys.path.insert(0, REPO)
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(REPO)
    return module


def turn(root: str, label: str, out_path: str) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import bifrost3d_tpu_torch
    if os.path.dirname(os.path.dirname(os.path.abspath(
            bifrost3d_tpu_torch.__file__))) != root:
        raise SystemExit(f"imported {bifrost3d_tpu_torch.__file__}, not {root}")
    from bifrost3d_tpu_torch.apps.scenes import (SCENES, TEST_SCENES,
                                                 torus_grid_mesh)
    from bifrost3d_tpu_torch.geometry import pallas_bvh as hier
    from bifrost3d_tpu_torch.geometry import pallas_bvh_vmem as vmem
    from bifrost3d_tpu_torch.geometry import pallas_clustered as clustered
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense
    from bifrost3d_tpu_torch.integrator import path_tracer as pt

    smoke = _smoke()
    dev = torch.device("cuda", 0)
    res, arrays, workloads = {"label": label}, {}, []
    inf = float("inf")

    def run(name, fn, repeats=20):
        """Outputs and call_ms of one workload; kernel_ms comes last, so
        ``fn`` binds what it uses."""
        out = fn()
        out = out if isinstance(out, tuple) else (out,)
        for k, x in enumerate(out):
            arrays[f"{name}:{k}".replace("/", ".")] = x.detach().cpu().numpy()
        res[f"{name}/call_ms"] = smoke._median_ms(fn, repeats=repeats)
        workloads.append((name, fn))

    # -- B4 on the bridge's 512² camera and incoherent rays, and on the torus
    # grid's ray sets ------------------------------------------------------------
    scene, camera = TEST_SCENES["hier_bridge_50k"](device=dev)
    trees = {"bridge": (hier.pack_hierarchical(scene.tri_verts, scene.bvh),
                        smoke._walk_rays(scene, camera, dev))}
    mesh = torus_grid_mesh()
    trees["torus_grid"] = (
        hier.pack_hierarchical(torch.tensor(mesh.positions[mesh.indices],
                                            device=dev)),
        smoke._torus_rays(dev))
    for tree_name, (tree, rays) in trees.items():
        for kind, (o, d) in rays.items():
            for any_hit in (False, True):
                name = f"bvh/{tree_name}/{kind}{'/any' if any_hit else ''}"
                run(name, lambda tree=tree, o=o, d=d, any_hit=any_hit: tuple(
                    hier.hierarchical_intersect_cuda(tree, o, d, 1e-4, inf,
                                                     any_hit=any_hit)))
    res["smi/bvh"] = smoke.smi()

    # -- B1 on its three tables, B6 and B7 on the bridge and the 16,130 soup --
    rng = np.random.default_rng(9)
    t_max = torch.tensor(rng.uniform(0.2, 4.0, smoke.R).astype(np.float32),
                         device=dev)
    soups = smoke._soups(dev)
    dense_rays = {}
    for table, tris, ray_sets in smoke._dense_cases(dev, soups):
        dense_rays[table] = ray_sets
        comp, n = dense.pack_triangles(tris)
        for kind, (o, d) in ray_sets.items():
            for case, bound, live in (("closest", inf, None),
                                      ("bounded", t_max, None),
                                      ("live", inf, smoke.R // 3)):
                run(f"dense/{table}/{kind}/{case}",
                    lambda comp=comp, n=n, o=o, d=d, bound=bound, live=live:
                    tuple(dense.pallas_intersect(comp, n, o, d, 1e-4, bound,
                                                 live_count=live)))
    walks = {}
    for table, tris, bvh, ray_sets in smoke._scan_cases(dev, soups):
        scan = clustered.pack_clustered(tris, bvh)
        for kind, (o, d) in ray_sets.items():
            run(f"clustered/{table}/{kind}",
                lambda scan=scan, o=o, d=d: tuple(clustered.clustered_intersect(
                    scan, o, d, 1e-4, inf)), repeats=10)
        walks[table] = (vmem.pack_vmem(tris, bvh), dict(ray_sets))
    walks["sphere"][1].update(dense_rays["sphere"])

    def walk_outputs(hit, any_hit):
        """B7's defined outputs: with any-hit the occlusion and t (t_min on
        a hit), whichever hit of a leaf the kernel keeps."""
        return (hit.prim >= 0, hit.t) if any_hit else tuple(hit)

    for table, (walk, ray_sets) in walks.items():
        for kind, (o, d) in ray_sets.items():
            for case, bound, any_hit, live in (
                    ("closest", inf, False, None), ("any", t_max, True, None),
                    ("live", inf, False, smoke.R // 3)):
                run(f"vmem/{table}/{kind}/{case}",
                    lambda walk=walk, o=o, d=d, bound=bound, any_hit=any_hit,
                    live=live: walk_outputs(vmem.vmem_intersect(
                        walk, o, d, 1e-4, bound, any_hit=any_hit,
                        live_count=live), any_hit), repeats=10)
    res["smi/traces"] = smoke.smi()

    # -- the gradient path: bench_backward's plain step on CornellBox at
    # 256², 2 bounces (chip_smoke's _tint_step), and the pooled wavefront's
    # 512² Cornell frame ----
    scene, camera = SCENES["CornellBox"](device=dev)
    base = pt.settings_for_scene(scene, max_bounce_count=smoke.TRAIN_BOUNCES)
    plain = base._replace(remat_bounces=False, detached_replay_vjp=False)
    with torch.no_grad():
        target = pt.render_sample(scene, camera, smoke.TRAIN_RES,
                                  smoke.TRAIN_RES, 0, base)
    smoke._tint_step(scene, camera, target, smoke.TRAIN_RES, 1, plain)
    steps = [smoke._tint_step(scene, camera, target, smoke.TRAIN_RES, n,
                              plain) for n in range(1, smoke.TRAIN_STEPS + 1)]
    res["train/plain/step_ms"] = statistics.median(s["ms"] for s in steps)
    arrays["train.plain.grad:0"] = steps[0]["grad"].cpu().numpy()
    settings = pt.settings_for_scene(scene, max_bounce_count=smoke.BOUNCES)
    arrays["pooled.cornell:0"] = pt.render_sample_pooled(
        scene, camera, smoke.RES, smoke.RES, 1, settings).cpu().numpy()
    frames = []
    for acc in (2, 3, 4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pt.render_sample_pooled(scene, camera, smoke.RES, smoke.RES, acc,
                                settings)
        torch.cuda.synchronize()
        frames.append((time.perf_counter() - t0) * 1e3)
    res["pooled/cornell/frame_ms"] = statistics.median(frames)
    res["smi/train"] = smoke.smi()

    # -- the pooled wavefront on hier_bridge_15k at 512², on B1 and on B6 ----
    scene, camera = TEST_SCENES["hier_bridge_15k"](device=dev)
    for packing in ("dense", "clustered"):
        if packing == "clustered":
            scene = scene._replace(tri_clustered=clustered.pack_clustered(
                scene.tri_verts, scene.bvh), tri_components=None)
        settings = pt.settings_for_scene(scene, max_bounce_count=smoke.BOUNCES)
        image = pt.render_sample_pooled(scene, camera, smoke.RES, smoke.RES, 1,
                                        settings)
        arrays[f"pooled.{packing}:0"] = image.cpu().numpy()
        frames = []
        for acc in (2, 3, 4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pt.render_sample_pooled(scene, camera, smoke.RES, smoke.RES, acc,
                                    settings)
            torch.cuda.synchronize()
            frames.append((time.perf_counter() - t0) * 1e3)
        res[f"pooled/{packing}/frame_ms"] = statistics.median(frames)
    res["smi/pooled"] = smoke.smi()
    for name, ms in smoke.device_ms(workloads).items():
        res[f"{name}/kernel_ms"] = ms

    np.savez(out_path, **arrays)
    print("RESULT " + json.dumps(res), flush=True)


def launches(root: str) -> None:
    """The launch counts of ``root``'s package (see the module's doc)."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from bifrost3d_tpu_torch.apps.scenes import SCENES
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    smoke = _smoke()
    dev = torch.device("cuda", 0)
    scene, camera = SCENES["CornellBox"](device=dev)
    frame = pt.settings_for_scene(scene, max_bounce_count=smoke.BOUNCES)
    base = pt.settings_for_scene(scene, max_bounce_count=smoke.TRAIN_BOUNCES)
    plain = base._replace(remat_bounces=False, detached_replay_vjp=False)
    with torch.no_grad():
        target = pt.render_sample(scene, camera, smoke.TRAIN_RES,
                                  smoke.TRAIN_RES, 0, base)
    # The pooled frame's iterations are its loop's; the train step's
    # render_sample runs a fixed number.
    _, _, pooled_iterations = pt.render_pixels_pooled(
        scene, camera, smoke.RES, smoke.RES, 1, frame, with_iters=True)
    work = {
        "pooled/cornell": (lambda: pt.render_sample_pooled(
            scene, camera, smoke.RES, smoke.RES, 1, frame),
            pooled_iterations),
        "train/plain": (lambda: smoke._tint_step(
            scene, camera, target, smoke.TRAIN_RES, 1, plain),
            pt._iterations(plain))}
    for fn, _ in work.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, (fn, _) in work.items():
            with record_function(f"launches:{name}"):
                fn()
                torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    out = {}
    for name, (_, iterations) in work.items():
        window = next(e.time_range for e in events
                      if e.name == f"launches:{name}" and e.device_type != cuda)
        inside = [e for e in events
                  if window.start <= e.time_range.start <= window.end]
        host = sum("LaunchKernel" in e.name for e in inside
                   if e.device_type != cuda)
        card = sum(e.device_type == cuda and not any(
            word in e.name for word in ("launches:", "Memset", "Memcpy"))
            for e in inside)
        out[name] = dict(host_launches=host, card_kernels=card,
                         iterations=iterations,
                         host_per_iteration=host / iterations,
                         card_per_iteration=card / iterations)
    print("LAUNCHES " + json.dumps(dict(root=root, **out)), flush=True)


def paired_turn(root: str) -> None:
    """One process of ``--pairs``: ``root``'s pooled Cornell frame and
    plain train step."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    from bifrost3d_tpu_torch.apps.scenes import SCENES
    from bifrost3d_tpu_torch.integrator import path_tracer as pt
    smoke = _smoke()
    dev = torch.device("cuda", 0)
    scene, camera = SCENES["CornellBox"](device=dev)
    frame = pt.settings_for_scene(scene, max_bounce_count=smoke.BOUNCES)
    base = pt.settings_for_scene(scene, max_bounce_count=smoke.TRAIN_BOUNCES)
    plain = base._replace(remat_bounces=False, detached_replay_vjp=False)
    with torch.no_grad():
        target = pt.render_sample(scene, camera, smoke.TRAIN_RES,
                                  smoke.TRAIN_RES, 0, base)
    frames = []
    for acc in range(1, 7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pt.render_sample_pooled(scene, camera, smoke.RES, smoke.RES, acc,
                                frame)
        torch.cuda.synchronize()
        frames.append((time.perf_counter() - t0) * 1e3)
    steps = [smoke._tint_step(scene, camera, target, smoke.TRAIN_RES, n,
                              plain)["ms"] for n in range(1, 7)]
    print("PAIRED " + json.dumps(dict(
        frame_ms=statistics.median(frames[1:]),
        step_ms=statistics.median(steps[1:]))), flush=True)


def pairs(rounds: int, other: str) -> int:
    """``--pairs``: see the module's doc."""
    out = {"other": [], "this": []}
    for _ in range(rounds):
        for label in ("other", "this", "this", "other"):
            root = other if label == "other" else REPO
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--paired-turn",
                 root], capture_output=True, text=True, timeout=600)
            lines = [line for line in proc.stdout.splitlines()
                     if line.startswith("PAIRED ")]
            if proc.returncode != 0 or not lines:
                print(proc.stdout[-4000:], proc.stderr[-4000:],
                      file=sys.stderr)
                return 1
            out[label].append(json.loads(lines[-1][len("PAIRED "):]))
    medians = {label: {key: statistics.median(r[key] for r in runs)
                       for key in ("frame_ms", "step_ms")}
               for label, runs in out.items()}
    print("PAIRS " + json.dumps(dict(runs=out, medians=medians, smi=smi())),
          flush=True)
    return 0


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def _same(a, b) -> bool:
    import numpy as np
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def compare(turns) -> dict:
    """Per workload: bit-equal between the trees (first turns), and each
    tree's two turns bit-equal."""
    import numpy as np
    data = {}
    for path, label in turns:
        data.setdefault(label, []).append(dict(np.load(path)))
    other, this = data["other"][0], data["this"][0]
    out = {}
    for key in sorted(set(other) | set(this)):
        name = key.rsplit(":", 1)[0]
        same = key in other and key in this and _same(other[key], this[key])
        out[name] = out.get(name, True) and same
    for label, runs in data.items():
        out[f"{label}_turns_bit_equal"] = all(
            _same(runs[0][key], runs[1][key]) for key in runs[0])
    return out


def build(root: str) -> subprocess.Popen:
    """Builds ``root``'s CUDA sources in parallel; prints each build's
    registers and spills."""
    code = ("import os, sys; sys.path.insert(0, sys.argv[1]);"
            "from concurrent.futures import ThreadPoolExecutor;"
            "from bifrost3d_tpu_torch.utils import cuda_build;"
            "csrc = os.path.join(sys.argv[1], 'bifrost3d_tpu_torch', 'csrc');"
            "srcs = sorted(f for f in os.listdir(csrc) if f.endswith('.cu'));"
            "paths = list(ThreadPoolExecutor(len(srcs)).map(cuda_build.build, srcs));"
            "[print(sys.argv[1], s, ' '.join(l.strip() for l in open(p[:-3] + '.log')"
            " if 'registers' in l or 'spill' in l or 'Compiling' in l))"
            " for s, p in zip(srcs, paths)]")
    return subprocess.Popen([sys.executable, "-c", code, root],
                            stdout=subprocess.PIPE, text=True)


def main(argv) -> int:
    if argv[:1] == ["--turn"]:
        turn(*argv[1:4])
        return 0
    if argv[:1] == ["--launches"]:
        launches(argv[1])
        return 0
    if argv[:1] == ["--paired-turn"]:
        paired_turn(argv[1])
        return 0
    if argv[:1] == ["--pairs"]:
        return pairs(int(argv[1]), os.path.abspath(argv[2]))
    if len(argv) != 1:
        print(__doc__)
        return 2
    other = os.path.abspath(argv[0])
    if not os.path.isdir(os.path.join(other, "bifrost3d_tpu_torch")):
        print(f"no bifrost3d_tpu_torch under {other}", file=sys.stderr)
        return 2
    print(smi(), flush=True)
    t0 = time.perf_counter()
    builds = [build(other), build(REPO)]
    for proc in builds:
        text, _ = proc.communicate()
        print(text.strip(), flush=True)
        if proc.returncode != 0:
            return 1
    print(f"built both trees in {time.perf_counter() - t0:.1f} s", flush=True)
    out_dir = os.path.join(REPO, "build", "compare")
    os.makedirs(out_dir, exist_ok=True)
    turns, results = [], []
    for k, label in enumerate(("other", "this", "this", "other")):
        root = other if label == "other" else REPO
        path = os.path.join(out_dir, f"turn{k}_{label}.npz")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn", root, label,
             path], capture_output=True, text=True, timeout=900)
        lines = [line for line in proc.stdout.splitlines()
                 if line.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
        results.append(json.loads(lines[-1][len("RESULT "):]))
        turns.append((path, label))
    print("BITEQ " + json.dumps(compare(turns)), flush=True)
    summary = {}
    for r in results:
        for key, value in r.items():
            if key.endswith("_ms"):
                summary.setdefault(key, {}).setdefault(r["label"], []).append(
                    value)
    print("SUMMARY " + json.dumps(summary), flush=True)
    for root in (other, REPO):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--launches", root],
            capture_output=True, text=True, timeout=600)
        lines = [line for line in proc.stdout.splitlines()
                 if line.startswith("LAUNCHES ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
