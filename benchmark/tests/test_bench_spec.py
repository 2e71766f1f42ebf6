"""BENCHMARK.json against the contract's shape, and every name in it
resolving to its files; a new cell and metric added as files alone."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], m["layer"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(cell):
    c = spec.resolve(cell)
    assert c.config["name"] == cell.split(".")[0]
    job = spec.job_module(c.traffic)
    for fn in ("setup", "window", "trace", "check", "calibrate"):
        assert callable(getattr(job, fn))
    assert set(c.checks["limits"])
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in reported
        assert callable(spec.metric_reader(m["name"]).read)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_under_paths(config):
    path = os.path.join(spec.ROOT, config["file"])
    assert config["file"].startswith("benchmark/configs/")
    with open(path) as f:
        cfg = json.load(f)
    assert cfg["source"] == config["source"]
    assert cfg["reduced"] == config["reduced"]


def test_new_cell_and_metric_are_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    cell and a per-layer metric by new files and new BENCHMARK.json
    entries; no file that was there changes, and the new names resolve."""
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p: open(os.path.join(tmp_path / "benchmark", p), "rb").read()
              for p in _files(tmp_path / "benchmark")}
    bench = json.loads(json.dumps(BENCH))
    b = tmp_path / "benchmark"
    shutil.copy(b / "configs" / "cornell_box.json",
                b / "configs" / "cornell_box_wide.json")
    (b / "traffic" / "render_short.json").write_text(json.dumps(
        dict(json.loads((b / "traffic" / "render.json").read_text()),
             accumulations=8)))
    shutil.copy(b / "checks" / "cornell_box.render.json",
                b / "checks" / "cornell_box_wide.render_short.json")
    (b / "metrics" / "jobs_traced.py").write_text(
        "def read(reading):\n    return float(reading['jobs'])\n")
    bench["configs"].append(dict(bench["configs"][0], name="cornell_box_wide",
                                 file="benchmark/configs/cornell_box_wide.json"))
    bench["workloads"].append(dict(bench["workloads"][0],
                                   name="cornell_box_wide.render_short",
                                   config="cornell_box_wide",
                                   traffic="render_short"))
    bench["per_layer"].append(dict(bench["per_layer"][0], name="jobs_traced",
                                   unit="jobs", source="program_counter",
                                   workloads=["cornell_box_wide.render_short"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from benchmark.harness import spec\n"
        "c = spec.resolve('cornell_box_wide.render_short')\n"
        "assert c.traffic['accumulations'] == 8\n"
        "names = [m['name'] for m in c.per_layer]\n"
        "assert 'jobs_traced' in names, names\n"
        "assert spec.metric_reader('jobs_traced').read({'jobs': 3}) == 3.0\n"
        "assert spec.job_module(c.traffic).setup\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                         capture_output=True, text=True, cwd=tmp_path,
                         timeout=120)
    assert out.stdout.strip() == "ok", out.stderr
    for p, data in before.items():
        assert open(os.path.join(b, p), "rb").read() == data, p


def _files(root):
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            yield os.path.relpath(os.path.join(dirpath, f), root)
