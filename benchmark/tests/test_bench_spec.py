"""BENCHMARK.json against the contract's shape, and every name in it
resolving to its files; every job holding faults and every configuration
a scene test; a new cell and metric added as files alone."""

import importlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import faults, spec
from benchmark.tests.conftest import with_pending

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



SCENE_TEST = os.path.join(spec.BENCH_DIR, "tests", "test_config_{}.py")


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_has_a_scene_test(config):
    """A SimpleViewer scene (its file names an ``upstream_scene``) is tied
    to the viewer's scene by ``test_bench_scenes.py``; a configuration of
    any other kind brings ``tests/test_config_<name>.py``."""
    cfg = spec._json(os.path.join(spec.ROOT, config["file"]))
    path = SCENE_TEST.format(config["name"])
    assert "upstream_scene" in cfg or os.path.exists(path), (
        f"configuration {config['name']!r} names no upstream_scene and has "
        f"no {os.path.relpath(path, spec.ROOT)}")


@pytest.mark.parametrize("job", sorted({
    spec.resolve(w["name"], with_pending()).traffic["job"]
    for w in with_pending()["workloads"]}))
def test_job_has_faults(job):
    """Every traffic job brings ``faults/<job>.py`` (``faults_of`` raises,
    naming the file, where there is none), whose faults name an attribute
    of the port and a wrapper of it."""
    found = faults.faults_of(job)
    assert found, f"job {job!r} has no faults"
    for name, (module, attr, wrap) in found.items():
        target = importlib.import_module("bifrost3d_tpu_torch." + module)
        assert callable(getattr(target, attr)) and callable(wrap), name


def _viewer_scene_copy(b, bench):
    """A configuration, a traffic mix of the existing job, a cell and a
    per-layer metric."""
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
    return (
        "c = spec.resolve('cornell_box_wide.render_short')\n"
        "assert c.traffic['accumulations'] == 8\n"
        "names = [m['name'] for m in c.per_layer]\n"
        "assert 'jobs_traced' in names, names\n"
        "assert spec.metric_reader('jobs_traced').read({'jobs': 3}) == 3.0\n"
        "assert spec.job_module(c.traffic).setup\n")


# SmallPT's nine spheres (smallpt.cpp, as Bifrost3D's apps/SmallPT has
# them): radius, position, emission, colour, BSDF (0 diffuse, 1 mirror,
# 2 glass).
SMALLPT_SPHERES = [
    [1e5, [1e5 + 1, 40.8, 81.6], [0, 0, 0], [0.75, 0.25, 0.25], 0],
    [1e5, [-1e5 + 99, 40.8, 81.6], [0, 0, 0], [0.25, 0.25, 0.75], 0],
    [1e5, [50, 40.8, 1e5], [0, 0, 0], [0.75, 0.75, 0.75], 0],
    [1e5, [50, 40.8, -1e5 + 170], [0, 0, 0], [0, 0, 0], 0],
    [1e5, [50, 1e5, 81.6], [0, 0, 0], [0.75, 0.75, 0.75], 0],
    [1e5, [50, -1e5 + 81.6, 81.6], [0, 0, 0], [0.75, 0.75, 0.75], 0],
    [16.5, [27, 16.5, 47], [0, 0, 0], [0.999, 0.999, 0.999], 1],
    [16.5, [73, 16.5, 78], [0, 0, 0], [0.999, 0.999, 0.999], 2],
    [600.0, [50, 681.6 - 0.27, 81.6], [12, 12, 12], [0, 0, 0], 0],
]

PROBE_SCENE_TEST = '''"""The sphere configuration against the port's SmallPT scene."""

import torch

from benchmark.harness import spec


def test_config_is_the_ports_smallpt_scene():
    from bifrost3d_tpu_torch.scene.spheres import (smallpt_scene,
                                                   sphere_scene_from_numpy)
    rows = spec._json(spec.BENCH_DIR + "/configs/{config}.json")["spheres"]
    none = [0.0] * len(rows)
    got = sphere_scene_from_numpy(dict(
        radius=[r[0] for r in rows], position=[r[1] for r in rows],
        emission=[r[2] for r in rows], color=[r[3] for r in rows],
        bsdf=[r[4] for r in rows], medium_sigma_t=none, medium_albedo=none,
        medium_g=none), device="cpu")
    want = smallpt_scene(device=torch.device("cpu"))
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
'''

PROBE_JOB = '''"""A traffic job of a new name, as a later cell would bring it."""


def setup(cell, seed, device, t0):
    return cell


def window(s, seconds):
    return {"attempted": 1, "failed": 0, "metrics": {}}


def trace(s):
    return {"segment": None, "jobs": 1}


def check(s):
    return {}


def calibrate(s, seed, control):
    return {}
'''

PROBE_FAULTS = '''"""The job's faults."""


def _scaled_hits(real):
    def intersect(*a, **kw):
        t, index, hit = real(*a, **kw)
        return t * 1.01, index, hit
    return intersect


FAULTS = {"hit_altered": ("scene.spheres", "intersect_spheres", _scaled_hits)}
'''


def _new_job_and_config_kind(b, bench, job="sphere_probe",
                             config="smallpt_probe", faults_file=True,
                             scene_test=True):
    """A job of a new name with its faults, a configuration that is no
    viewer scene with its own scene test, a cell that joins them, its
    end-to-end metric and a per-layer reader."""
    cell = f"{config}.{job}"
    source = "https://github.com/papaboo/Bifrost3D/tree/master/apps/SmallPT"
    (b / "configs" / f"{config}.json").write_text(json.dumps(
        {"name": config, "source": source, "reduced": [], "width": 1024,
         "height": 768, "spheres": SMALLPT_SPHERES}))
    if scene_test:
        (b / "tests" / f"test_config_{config}.py").write_text(
            PROBE_SCENE_TEST.replace("{config}", config))
    (b / "jobs" / f"{job}.py").write_text(PROBE_JOB)
    if faults_file:
        (b / "faults" / f"{job}.py").write_text(PROBE_FAULTS)
    (b / "traffic" / f"{job}.json").write_text(json.dumps(
        {"job": job, "accumulations": 64}))
    (b / "checks" / f"{cell}.json").write_text(json.dumps(
        {"pixels": 4096, "limits": {"rel_rms": 0.2}}))
    (b / "metrics" / f"{job}_rays.py").write_text(
        "def read(reading):\n    return float(reading['jobs'])\n")
    bench["configs"].append({"name": config, "source": source,
                             "file": f"benchmark/configs/{config}.json",
                             "reduced": [], "why": "nine spheres"})
    bench["workloads"].append({"name": cell, "config": config,
                               "traffic": job, "chips": 1, "why": "a probe"})
    bench["end_to_end"].append({"name": f"{job}_samples_per_s",
                                "unit": "samples/s", "better": "higher",
                                "bound": 0.2, "source": "host_clock",
                                "workloads": [cell]})
    bench["per_layer"].append({"name": f"{job}_rays", "unit": "rays",
                               "better": "higher", "source": "program_counter",
                               "layer": "smallpt",
                               "moves": f"{job}_samples_per_s",
                               "workloads": [cell]})
    reader = job + "_rays"
    return (
        f"c = spec.resolve({cell!r})\n"
        f"assert c.traffic['job'] == {job!r}\n"
        "assert 'upstream_scene' not in c.config\n"
        f"assert {reader!r} in [m['name'] for m in c.per_layer]\n"
        f"assert spec.metric_reader({reader!r}).read({{'jobs': 3}}) == 3.0\n"
        "assert spec.job_module(c.traffic).setup\n"
        "from benchmark.harness import faults\n"
        f"assert list(faults.faults_of({job!r})) == ['hit_altered']\n")


def _pytest_in(root, args, env):
    return subprocess.run([sys.executable, "-m", "pytest", "-q",
                           "-p", "no:cacheprovider", *args],
                          capture_output=True, text=True, cwd=root, env=env,
                          timeout=600)


@pytest.mark.parametrize("case", [_viewer_scene_copy, _new_job_and_config_kind],
                         ids=["viewer_scene_copy", "new_job_and_config_kind"])
def test_new_cell_and_metric_are_files_alone(tmp_path, case):
    """A copy of the benchmark gains a cell and a per-layer metric by new
    files and new BENCHMARK.json entries: a configuration and a traffic mix
    for an existing job and kind of configuration, or a job of a new name
    with its faults and a configuration of a new kind with its scene test.
    No file that was there changes and the new names resolve; in the
    second case the copy's tests collect with no error, and the tests
    that hold every job and configuration to their files pass on them and
    fail, naming them, without those files."""
    b = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH_DIR, b,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p: (b / p).read_bytes() for p in _files(b)}
    bench = json.loads(json.dumps(BENCH))
    check = case(b, bench)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = ("import sys; sys.path.insert(0, sys.argv[1])\n"
              "from benchmark.harness import spec\n" + check + "print('ok')\n")
    # The copy's benchmark first; the port from this checkout.
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(tmp_path), spec.ROOT]))
    out = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                         capture_output=True, text=True, cwd=tmp_path,
                         env=env, timeout=120)
    assert out.stdout.strip() == "ok", out.stderr
    if case is _new_job_and_config_kind:
        _collects_and_holds_files(tmp_path, b, bench, env)
    for p, data in before.items():
        assert (b / p).read_bytes() == data, p


def _collects_and_holds_files(tmp_path, b, bench, env):
    collected = _pytest_in(tmp_path, ["benchmark/tests", "--collect-only"],
                           env)
    assert collected.returncode == 0, collected.stdout[-4000:]
    for name in ("test_job_has_faults[sphere_probe]",
                 "test_config_has_a_scene_test[smallpt_probe]",
                 "test_fault_makes_correct_false[smallpt_probe.sphere_probe-"
                 "hit_altered]",
                 "test_config_is_the_ports_smallpt_scene"):
        assert name in collected.stdout, name
    assert "viewer_scene[smallpt_probe]" not in collected.stdout
    held = ["benchmark/tests/test_bench_spec.py::" + t for t in (
        "test_config_has_a_scene_test", "test_job_has_faults",
        "test_cell_resolves_to_its_files", "test_config_file_under_paths")]
    ran = _pytest_in(tmp_path,
                     held + ["benchmark/tests/test_config_smallpt_probe.py"],
                     env)
    assert ran.returncode == 0, ran.stdout[-4000:]
    # A job without its faults file and a configuration without its scene
    # test: the copy still collects, and the two tests fail, naming them.
    _new_job_and_config_kind(b, bench, job="bare_job", config="bare_probe",
                             faults_file=False, scene_test=False)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    collected = _pytest_in(tmp_path, ["benchmark/tests", "--collect-only"],
                           env)
    assert collected.returncode == 0, collected.stdout[-4000:]
    ran = _pytest_in(tmp_path, held[:2], env)
    assert ran.returncode == 1 and "2 failed" in ran.stdout, ran.stdout[-4000:]
    assert "test_job_has_faults[bare_job]" in ran.stdout
    assert "test_config_has_a_scene_test[bare_probe]" in ran.stdout


def _files(root):
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            yield os.path.relpath(os.path.join(dirpath, f), root)
