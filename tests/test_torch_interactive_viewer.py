"""The port's interactive viewer against ``tests/test_interactive_viewer.py``
and the JAX package's.

The scripted session (WASD moves, 'p' toggles the renderer, 'x' writes a
screenshot) and the settings panel mirror the JAX tests on the CPU;
``frame_to_ansi`` must give JAX's string for the same image, and the
camera navigation JAX's transform for the same keys.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per test worker)

from bifrost3d_tpu.apps import interactive_viewer as jax_viewer
from bifrost3d_tpu.core.input import Keyboard as JaxKeyboard

from bifrost3d_tpu_torch.apps.interactive_viewer import (
    CameraNavigation,
    RenderingPanel,
    build_scene,
    frame_to_ansi,
    main,
    run,
)
from bifrost3d_tpu_torch.core.input import Keyboard

CPU = torch.device("cpu")


def test_scripted_session_toggles_and_moves(tmp_path, capsys):
    shot = tmp_path / "shot.png"
    frames, data, comp = run(
        scene_name="Sphere", width=32, height=24, ticks=6,
        scripted_keys="wwpx", display=False, screenshot_path=str(shot),
        max_bounce=1, device=CPU)
    cam = next(iter(data.cameras))
    frame = frames[int(cam)]
    assert frame.shape == (24, 32, 3) and frame.device == CPU
    assert bool(torch.isfinite(frame).all())
    assert comp.renderers.get_name(data.cameras.get_renderer(cam)) == "Preview"
    t = data.cameras.get_transform(cam)
    assert float(t.translation[2]) > -3.0
    assert t.translation.device == CPU
    assert shot.exists()
    # Without a terminal the run prints nothing, as JAX's does.
    assert capsys.readouterr().out == ""


def test_settings_panel_adjusts_renderer_live():
    keys = ["", "", "g", "down", "right", "g", "", ""]
    frames, data, comp = run(
        scene_name="Sphere", width=16, height=12, ticks=len(keys) + 1,
        scripted_keys=keys, display=False, max_bounce=1, device=CPU)
    cam = next(iter(data.cameras))
    backend = comp._backends[(int(cam), data.cameras.get_renderer(cam))]
    assert backend.settings.max_bounce_count == 2
    assert 0 < backend.accumulations < len(keys) + 1
    assert bool(torch.isfinite(frames[int(cam)]).all())

    panel = RenderingPanel(data, comp, cam, [("PathTracer", 0)])
    panel.open = True
    lines = panel.lines()
    assert any("max bounces" in ln for ln in lines)
    assert any(ln.lstrip().startswith(">") for ln in lines)


class _Backend:
    """A backend's settings surface without a renderer behind it."""

    def __init__(self, settings):
        self.settings = settings
        self.resets = 0

    def reset(self):
        self.resets += 1


def test_panel_rows_match_jax():
    """The panel's rows, in order and wording, after every key of a walk
    through all its rows, with JAX's on the same keys."""
    from bifrost3d_tpu.core.compositor import Compositor as JaxCompositor
    from bifrost3d_tpu.integrator.path_tracer import (
        RenderSettings as JaxRenderSettings)
    from bifrost3d_tpu_torch.core.compositor import Compositor
    from bifrost3d_tpu_torch.integrator.path_tracer import RenderSettings
    keys = (["g"] + ["down", "right", "right", "left"] * 11
            + ["up", "esc", "g", "x"])
    out = {}
    for key, mod, comp_type, settings in (
            ("port", None, lambda d: Compositor(d, device=CPU),
             RenderSettings(max_bounce_count=1)),
            ("jax", jax_viewer, JaxCompositor,
             JaxRenderSettings(max_bounce_count=1))):
        data, cam = (mod.build_scene if mod else build_scene)("Box")
        comp = comp_type(data)
        ids = [(name, comp.add_renderer(name, None))
               for name in ("PathTracer", "Preview", "Denoised")]
        backend = _Backend(settings)
        for _, rid in ids:
            comp._backends[(int(cam), rid)] = backend
        panel = (mod.RenderingPanel if mod else RenderingPanel)(
            data, comp, cam, ids)
        said = []
        for k in keys:
            said.append((panel.handle(k), panel.lines(), backend.resets))
        out[key] = said
    assert out["port"] == out["jax"]
    assert any("bloom threshold: 4.0" in ln for _, lines, _ in out["port"]
               for ln in lines)


def test_frame_to_ansi_equals_jax():
    rng = np.random.default_rng(14)
    img = rng.uniform(-0.2, 1.2, (7, 5, 3)).astype(np.float32)
    img[0, 0] = (1.0, 0.0, 0.0)
    s = frame_to_ansi(torch.tensor(img))
    assert s == jax_viewer.frame_to_ansi(jnp.asarray(img))
    assert s == frame_to_ansi(img)
    lines = s.split("\n")
    assert len(lines) == 4
    assert "38;2;255;0;0" in lines[0]


@pytest.mark.parametrize("keys", ["wwd", "sa", "eq", ["right", "up"],
                                  ["left", "w", "down", "d"]])
def test_camera_navigation_matches_jax(keys):
    port_data, port_cam = build_scene("Sphere")
    jax_data, jax_cam = jax_viewer.build_scene("Sphere")
    nav = CameraNavigation(port_data, port_cam)
    jnav = jax_viewer.CameraNavigation(jax_data, jax_cam)
    for key in keys:
        for kb_type, n in ((Keyboard, nav), (JaxKeyboard, jnav)):
            kb = kb_type()
            kb.press(key)
            kb.release(key)
            n.handle(kb, 1.0 / 30)
    port = port_data.cameras.get_transform(port_cam)
    ref = jax_data.cameras.get_transform(jax_cam)
    for a, b in zip(port, ref):
        assert a.device == CPU
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    assert port_data.cameras.changes.any_changes


def test_main_runs_headless(tmp_path, capsys):
    shot = tmp_path / "m.png"
    main(["--device", "cpu", "--scene", "Box", "--window-size", "8x6",
          "--ticks", "3", "--keys", "x", "--screenshot", str(shot),
          "--max-bounce", "1"])
    assert shot.exists()
    # JAX's main prints nothing either.
    assert capsys.readouterr().out == ""


def test_headless_run_prints_what_jax_prints(tmp_path, capsys):
    """Fault C9: without a terminal the port's ``run`` printed its last
    status line, JAX's nothing. Both runs' stdout must be equal."""
    said = []
    for run_fn, kw in ((jax_viewer.run, {}), (run, {"device": CPU})):
        run_fn(scene_name="Box", width=8, height=6, ticks=3,
               scripted_keys="wx", display=False,
               screenshot_path=str(tmp_path / "shot.png"), max_bounce=1,
               **kw)
        said.append(capsys.readouterr().out)
    assert said[1] == said[0] == ""


def test_terminal_run_presents_the_status_line(capsys):
    """With a display, each presented frame ends in the status line:
    window name, frames per second, samples per pixel, key help."""
    run(scene_name="Box", width=8, height=6, ticks=3, display=True,
        max_bounce=1, device=CPU)
    status = capsys.readouterr().out.split("\x1b[K")[-1].strip()
    assert status.startswith("bifrost3d_tpu | PathTracer | ")
    assert " fps | 3 spp | WASD move" in status, status


def test_main_defaults_to_the_card(monkeypatch):
    import bifrost3d_tpu_torch.apps.interactive_viewer as iv
    seen = {}
    monkeypatch.setattr(iv, "run", lambda *a, **kw: seen.update(kw))
    main([])
    assert seen["device"] == torch.device("cuda")
