"""One run of one cell: set-up, the measured window, the traced segment
(``--trace 1``), the output check, and the result line.

The last line of standard output is one JSON object with ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and with ``--trace 1``
``breakdown``) and, last, ``checks``: each number compared with its
limit, which the last lines of standard error repeat.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from benchmark.harness import spec

# Top-level module names that may not be loaded in a run: JAX and the JAX
# package the port was made from (names compared whole, since the port's
# own name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "bifrost3d_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info(device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": device.type, "kind": device.type, "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": peak}


def _refuse(message: str) -> int:
    print(f"benchmark: {message}", file=sys.stderr, flush=True)
    return 2


def main(t0: float, argv=None, device=None) -> int:
    """``device`` None runs on the card and refuses to run without one;
    a test passes ``torch.device("cpu")`` to drive the rest of a run."""
    args = parse(argv)
    cell = spec.resolve(args.workload)
    if device is None:
        if not torch.cuda.is_available():
            return _refuse("torch.cuda.is_available() is false: the cells "
                           "measure the port on a CUDA card only")
        if torch.cuda.device_count() < cell.chips:
            return _refuse(f"{cell.name} needs {cell.chips} cards, "
                           f"{torch.cuda.device_count()} visible")
        device = torch.device("cuda", 0)
    job = spec.job_module(cell.traffic)
    state = job.setup(cell, args.seed, device, t0)
    window = job.window(state, args.seconds)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        return _refuse(f"modules loaded that a run may not load: {found}")

    out_device = device_info(device, int(peak))
    metrics, breakdown = {}, None
    if args.trace:
        reading = job.trace(state)
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out_device["busy_s"] = reading["busy_s"]
        out_device["window_s"] = reading["window_s"]
        breakdown = reading["breakdown"]
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": window["metrics"][m["name"]],
                                  "unit": m["unit"]}

    checks = job.check(state)
    correct = all(not math.isnan(v) and v <= limit
                  for v, limit in checks.values())
    found = forbidden_modules()
    if found:
        return _refuse(f"modules loaded that a run may not load: {found}")
    result = {"correct": correct, "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics,
              "device": out_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": limit}
                        for name, (v, limit) in checks.items()}
    for name, (v, limit) in checks.items():
        print(f"check {name} {v!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
