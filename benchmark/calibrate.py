"""The readings behind a cell's limits, in one process: the check's
numbers for the program on many seeds and for the control on some.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --control-seeds 1,2

Prints one JSON line per seed and a summary line: per number the largest
reading of the program and the smallest of the control. The benchmark's
own runs never run it.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
sys.path[0] = ROOT


def main() -> int:
    import torch

    from benchmark.harness import spec
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", default=None,
                   help="read the numbers with this fault of harness/faults.py "
                        "planted under the timed path (after set-up)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.resolve(args.workload)
    job = spec.job_module(cell.traffic)
    seeds = [int(x) for x in args.seeds.split(",") if x]
    controls = {int(x) for x in args.control_seeds.split(",") if x}
    if args.fault:
        from benchmark.harness import faults
        faults.plant(cell.traffic["job"], args.fault)
    state = job.setup(cell, seeds[0], torch.device("cuda", 0), T0)
    program, control = {}, {}
    for seed in seeds:
        out = job.calibrate(state, seed, seed in controls)
        print(json.dumps({"seed": seed, **out}), flush=True)
        for name, v in out["program"].items():
            program[name] = max(program.get(name, v), v)
        for name, v in out.get("control", {}).items():
            control[name] = min(control.get(name, v), v)
    print(json.dumps({"workload": cell.name, "fault": args.fault,
                      "program_max": program,
                      "control_min": control,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
