"""``BENCHMARK.json`` and the files its names lead to.

Everything of one configuration, traffic mix, cell or per-layer metric is
found by name, so a later change adds a cell or a metric as new files and
new entries: ``configs/<config>.json`` (the configuration's ``file``),
``traffic/<traffic>.json`` (its ``job`` names ``jobs/<job>.py``, the
general loop that reads it), ``checks/<cell>.json`` (the size and the
limits of the cell's output check) and ``metrics/<metric>.py`` (one
per-layer reader).
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    checks: dict
    end_to_end: list     # the BENCHMARK.json entries this cell reports
    per_layer: list


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether ``cell`` reports ``metric``: the metric lists the cell, or
    lists no cells and (for a per-layer metric) the cell reports the
    end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def resolve(name: str, bench: dict | None = None, root: str = ROOT) -> Cell:
    bench = bench if bench is not None else load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(root, configs[cell["config"]]["file"]))
    traffic = _json(os.path.join(BENCH_DIR, "traffic",
                                 cell["traffic"] + ".json"))
    checks = _json(os.path.join(BENCH_DIR, "checks", name + ".json"))
    e2e = [m for m in bench["end_to_end"] if reports(m, name, set())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if reports(m, name, e2e_names)]
    return Cell(name, int(cell["chips"]), config, traffic, checks, e2e,
                per_layer)


def _load(path: str, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def job_module(traffic: dict):
    """The general loop that ``traffic["job"]`` names."""
    return _load(os.path.join(BENCH_DIR, "jobs", traffic["job"] + ".py"),
                 "benchmark_job_" + traffic["job"])


def metric_reader(name: str):
    """The reader of per-layer metric ``name``: a module with ``read(reading)
    → float or None``."""
    return _load(os.path.join(BENCH_DIR, "metrics", name + ".py"),
                 "benchmark_metric_" + name.replace(".", "_").replace("-", "_"))
