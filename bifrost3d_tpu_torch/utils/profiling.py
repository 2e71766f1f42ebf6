"""Profiling helpers: named stage timings, a frame-rate meter, a device
trace, the port's own spans and a snapshot of its counters.

Port of ``bifrost3d_tpu/utils/profiling.py`` (``device_trace``,
``StageTimings``, ``FrameTimer``), the counterparts of the reference's
``PerformanceMarker`` GPU scopes and the viewer's 8-frame moving-average
FPS (``SimpleViewer/main.cpp:72-88``). A stage's scope waits for the
device of the tensors it is given before it stops its clock, as JAX's
``block_until_ready`` does, so that it times the device's work and not
the dispatch; it also annotates a running ``torch.profiler`` trace.

:func:`span` marks a layer boundary of the render path (``b3d.`` names)
in a running ``torch.profiler`` session and costs one check when none
runs; :func:`counters` reads the launch, cache and build counters the
modules keep.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import OrderedDict, deque

import torch

SPAN_PREFIX = "b3d."
_PACKAGE = __name__.split(".")[0] + "."
_NO_SPAN = contextlib.nullcontext()
# A module's int counters, by attribute, and the names counters() gives them.
_COUNTS = {"launch_count": "launches",
           "accumulate_count": "accumulated_frames"}


def span(name: str):
    """A host span ``b3d.<name>`` while a ``torch.profiler`` session runs,
    else one shared no-op context (the session is the only switch).

    The span is a function-scope record (``_RecordFunctionFast``): kineto
    places it on the card's clock among the host's operators, and unlike
    ``record_function``'s user annotation it leaves no copy among the
    card's activities, so a trace's device events, launches and busy time
    are the same with or without it."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + name)


def counters() -> dict:
    """{name: int} of the counters the port's loaded modules keep: each
    kernel wrapper's ``launch_count`` as ``<module>.launches`` (and the mesh
    megakernel's ``accumulate_count``, the accumulations it lerped into a
    running mean, as ``<module>.accumulated_frames``), each
    module-level ``VersionedCache``'s ``stores`` (misses that rebuilt a
    table) as ``<module>.<cache>.stores``, and ``utils.cuda_build``'s
    ``builds`` (nvcc runs) and ``loads`` (libraries loaded). Modules are
    named below the package; none is imported."""
    versioned = sys.modules.get(_PACKAGE + "utils.versioned")
    cache_type = versioned.VersionedCache if versioned else ()
    out = {}
    for name, module in list(sys.modules.items()):
        if not name.startswith(_PACKAGE) or module is None:
            continue
        short = name[len(_PACKAGE):]
        for attr, value in list(vars(module).items()):
            if attr in _COUNTS and isinstance(value, int):
                out[f"{short}.{_COUNTS[attr]}"] = value
            elif isinstance(value, cache_type):
                out[f"{short}.{attr}.stores"] = value.stores
    build = sys.modules.get(_PACKAGE + "utils.cuda_build")
    if build is not None:
        out["utils.cuda_build.builds"] = build.builds
        out["utils.cuda_build.loads"] = build.loads
    return dict(sorted(out.items()))


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of everything inside the scope
    (host activity, and the card's kernels where CUDA is available) and
    write it to ``log_dir/trace.json`` as a Chrome trace, viewable in
    Perfetto or chrome://tracing. The JAX package writes an XLA trace for
    TensorBoard here instead."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _synchronize(x) -> None:
    """Wait for the device work behind ``x`` (a tensor, or a tuple, list
    or dict of them); CPU tensors need no wait."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _synchronize(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _synchronize(v)


class StageTimings:
    """Named wall-clock scopes with device synchronization.

    >>> timings = StageTimings()
    >>> with timings.scope("trace", result):   # waits for result's device
    ...     pass

    Accumulates total seconds and call counts per stage; ``report()``
    renders a fixed-width summary.
    """

    def __init__(self):
        self._acc = OrderedDict()

    @contextlib.contextmanager
    def scope(self, name: str, *block_on):
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
            for x in block_on:
                _synchronize(x)
        dt = time.perf_counter() - t0
        total, count = self._acc.get(name, (0.0, 0))
        self._acc[name] = (total + dt, count + 1)

    def timings(self):
        """{name: (total_seconds, call_count)}."""
        return dict(self._acc)

    def report(self) -> str:
        lines = ["stage                     total_s    calls   ms/call"]
        for name, (total, count) in self._acc.items():
            lines.append(f"{name:<24} {total:>8.3f} {count:>8d} "
                         f"{1e3 * total / count:>9.3f}")
        return "\n".join(lines)

    def reset(self):
        self._acc.clear()


class FrameTimer:
    """Moving-average FPS over the last N frames (default 8, like the
    SimpleViewer title bar)."""

    def __init__(self, window: int = 8):
        self._times = deque(maxlen=window + 1)

    def tick(self, now: float = None):
        self._times.append(time.perf_counter() if now is None else now)

    @property
    def fps(self) -> float:
        if len(self._times) < 2:
            return 0.0
        span = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / span if span > 0 else 0.0
