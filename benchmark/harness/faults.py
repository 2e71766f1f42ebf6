"""Faults planted under the timed path, to show that the output check
catches them: a test drives a whole run with one in place, and
``calibrate.py --fault`` reads the check's numbers with one at a cell's
own size.

Each traffic job keeps its faults in ``faults/<job>.py``, found by the
job's name: ``FAULTS = {name: (module of bifrost3d_tpu_torch, attribute,
wrapper of the real attribute)}``.
"""

from __future__ import annotations

import importlib
import os

from benchmark.harness import spec


def faults_of(job: str) -> dict:
    """The faults of traffic job ``job``; FileNotFoundError where the job
    has no faults file."""
    path = os.path.join(spec.BENCH_DIR, "faults", job + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"job {job!r} has no faults file {path}")
    return spec.load_module(path, "benchmark_faults_" + job).FAULTS


def plant(job: str, name: str, setattr_fn=setattr):
    """Put fault ``name`` of the traffic job ``job`` in place (``setattr_fn`` lets a
    test's monkeypatch undo it)."""
    module_name, attr, wrap = faults_of(job)[name]
    module = importlib.import_module("bifrost3d_tpu_torch." + module_name)
    setattr_fn(module, attr, wrap(getattr(module, attr)))
