"""Each configuration's file against the published scene it stands for:
the port builds from the file, through the harness, exactly the scene and
camera that ``apps/simple_viewer.viewer_scene`` builds for the upstream
scene at the configuration's size and background."""

import pytest
import torch

from benchmark.harness import program, spec
from benchmark.reference.scene import raw_scene

CONFIGS = spec.load_benchmark()["configs"]


def _leaves(x, path="scene"):
    """(path, tensor) of every tensor in a tree of NamedTuples, lists and
    dicts, in a fixed order."""
    if isinstance(x, torch.Tensor):
        yield path, x
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        for name in x._fields:
            yield from _leaves(getattr(x, name), f"{path}.{name}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{path}[{i}]")
    elif isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k], f"{path}[{k!r}]")


def _assert_same(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert torch.equal(g, w), path


@pytest.mark.parametrize("config", [c["name"] for c in CONFIGS])
def test_config_builds_the_viewer_scene(config):
    from bifrost3d_tpu_torch.apps.simple_viewer import viewer_scene
    cfg = next(spec._json(f"{spec.ROOT}/{c['file']}") for c in CONFIGS
               if c["name"] == config)
    cpu = torch.device("cpu")
    want_scene, want_camera = viewer_scene(
        cfg["upstream_scene"], None, tuple(cfg["environment_tint"]),
        cfg["width"], cfg["height"], device=cpu)
    got_scene = program.build_scene(raw_scene(cfg), cpu)
    got_camera = program.camera(cfg["camera"], cfg["width"], cfg["height"],
                                cpu)
    _assert_same(got_scene, want_scene)
    _assert_same(got_camera, want_camera)
