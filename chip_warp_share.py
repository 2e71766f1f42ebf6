"""The warp-share threshold of ``csrc/dense_trace.cuh`` (``kWarpShare``)
swept on the dense trace (B1), the cluster scan (B6) and the
resident-cluster walk (B7) on one CUDA card.

Usage, from the root of this tree::

    python3 chip_warp_share.py

For each threshold in ``THRESHOLDS`` (0: a thread per ray always; 1 << 20:
the warp on one ray at a time always) it builds ``csrc/dense_intersect.cu``,
``csrc/clustered_intersect.cu`` and ``csrc/vmem_intersect.cu`` with that
``kWarpShare`` into ``build/warp_share/<threshold>/``, all builds at once,
then times every build in one torch.profiler session
(``chip_smoke.device_ms``: device time per call, mean of 10 calls) on
chip_smoke.py's workloads: B1 on three tables and two ray sets, with
t_max = inf and on the bounded rays; B6 on the bridge's two ray sets and the
16,130-triangle soup; B7 on the same three, closest hit with t_max = inf and
on the bounded rays, and any-hit on the bounded rays. The hits (t, prim, u,
v) of every build are checked equal to the committed build's. It prints the
card, one line per workload and, last, one JSON object
``{workload: {threshold: ms}}``.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
THRESHOLDS = (0, 4, 8, 16, 32, 1 << 20)
SOURCES = {"dense_intersect": ("dense_intersect", "dense_intersect_boxes"),
           "clustered_intersect": ("clustered_intersect",
                                   "clustered_intersect_boxes"),
           "vmem_intersect": ("vmem_intersect", "vmem_intersect_boxes")}


def _smoke():
    """chip_smoke.py of this tree, for its helpers (its main does not run)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build(threshold: int) -> dict:
    """The sources with kWarpShare = ``threshold`` → {source: .so path}."""
    from bifrost3d_tpu_torch.utils import cuda_build
    out_dir = os.path.join(REPO, "build", "warp_share", str(threshold))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(cuda_build.CSRC_DIR, "dense_trace.cuh")) as f:
        header, n = re.subn(r"constexpr int kWarpShare = \d+;",
                            f"constexpr int kWarpShare = {threshold};",
                            f.read())
    if n != 1:
        raise RuntimeError("kWarpShare not found in dense_trace.cuh")
    with open(os.path.join(out_dir, "dense_trace.cuh"), "w") as f:
        f.write(header)
    paths = {}
    for stem in SOURCES:
        src = shutil.copy(os.path.join(cuda_build.CSRC_DIR, stem + ".cu"),
                          out_dir)
        paths[stem] = os.path.join(out_dir, f"lib{stem}.so")
        proc = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS,
                               "-o", paths[stem], src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {stem} at {threshold}:\n"
                               f"{proc.stdout}{proc.stderr}")
    return paths


def main() -> int:
    sys.path.insert(0, REPO)
    import torch
    from bifrost3d_tpu_torch.geometry import pallas_bvh_vmem as vmem
    from bifrost3d_tpu_torch.geometry import pallas_clustered as clustered
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense
    from bifrost3d_tpu_torch.geometry.bvh import build_soup_bvh

    smoke = _smoke()
    smoke.device_phase()    # prints the card's name and power limit
    with ThreadPoolExecutor(len(THRESHOLDS)) as pool:
        built = dict(zip(THRESHOLDS, pool.map(build, THRESHOLDS)))
    modules = {"dense_intersect": dense, "clustered_intersect": clustered,
               "vmem_intersect": vmem}
    committed = {stem: mod._library() for stem, mod in modules.items()}
    libraries = {}
    for threshold, paths in built.items():
        for stem, names in SOURCES.items():
            lib = ctypes.CDLL(paths[stem])
            for name in names:
                getattr(lib, name).argtypes = getattr(committed[stem],
                                                      name).argtypes
                getattr(lib, name).restype = ctypes.c_int
            libraries[threshold, stem] = lib

    def use(threshold):
        """Route the modules to ``threshold``'s build (None: committed)."""
        for stem, mod in modules.items():
            lib = (committed[stem] if threshold is None
                   else libraries[threshold, stem])
            mod._library = (lambda lib=lib: lib)

    dev = torch.device("cuda", 0)
    inf = float("inf")
    soups = smoke._soups(dev)
    cases = []
    for name, tris, ray_sets in smoke._dense_cases(dev, soups):
        comp, n = dense.pack_triangles(tris)
        for ray_name, (o, d) in ray_sets.items():
            t_max = smoke._bounded(dense.dense_intersect_cuda(
                comp, n, o, d, 1e-4, inf))
            for case, bound in (("", inf), ("/bounded", t_max)):
                cases.append((f"B1 {name}/{ray_name}{case}",
                              lambda comp=comp, n=n, o=o, d=d, b=bound:
                              dense.dense_intersect_cuda(comp, n, o, d, 1e-4,
                                                         b)))
    for name, tris, bvh, ray_sets in smoke._scan_cases(dev, soups):
        bvh = bvh if bvh is not None else build_soup_bvh(tris)
        scan = clustered.pack_clustered(tris, bvh)
        walk = vmem.pack_vmem(tris, bvh)
        for ray_name, (o, d) in ray_sets.items():
            cases.append((f"B6 {name}/{ray_name}",
                          lambda scan=scan, o=o, d=d:
                          clustered.clustered_intersect_cuda(
                              scan, o, d, 1e-4, inf)))
            t_max = smoke._bounded(vmem.vmem_intersect_cuda(walk, o, d, 1e-4,
                                                            inf))
            for case, bound in (("", inf), ("/bounded", t_max)):
                cases.append((f"B7 {name}/{ray_name}{case}",
                              lambda walk=walk, o=o, d=d, b=bound:
                              vmem.vmem_intersect_cuda(walk, o, d, 1e-4, b)))
            cases.append((f"B7 {name}/{ray_name}/any-hit",
                          lambda walk=walk, o=o, d=d, b=t_max:
                          vmem.vmem_intersect_cuda(walk, o, d, 1e-4, b,
                                                   any_hit=True)))

    failures, workloads = [], []
    for name, fn in cases:
        use(None)
        want = fn()
        for threshold in THRESHOLDS:
            use(threshold)
            got = fn()
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                failures.append(f"{name} at {threshold}")
            workloads.append((f"{name}@{threshold}",
                              lambda fn=fn, threshold=threshold:
                              (use(threshold), fn())))
    times = smoke.device_ms(workloads)
    table = {}
    for key, ms in times.items():
        name, threshold = key.rsplit("@", 1)
        table.setdefault(name, {})[threshold] = ms
    print("device ms per call (torch.profiler, mean of 10) at kWarpShare "
          + " / ".join(str(t) for t in THRESHOLDS), flush=True)
    for name, row in table.items():
        print(f"{name:34s} " + " ".join(
            f"{row[str(t)]:.4f}" if row[str(t)] is not None else "none"
            for t in THRESHOLDS), flush=True)
    print(json.dumps(table))
    if failures:
        print("hits differ from the committed build: " + "; ".join(failures),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
