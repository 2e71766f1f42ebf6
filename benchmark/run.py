"""The benchmark of ``bifrost3d_tpu_torch``: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
The cells, their metrics and their bounds are in ``BENCHMARK.json``; what
each name leads to is in ``benchmark/harness/spec.py``.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Build and kernel caches live at fixed paths inside the checkout, so only
# a checkout's first run builds; the port's own nvcc and g++ builds go to
# build/kernels and build/native beside them.
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
sys.path[0] = ROOT

if __name__ == "__main__":
    from benchmark.harness.cli import main
    sys.exit(main(T0))
