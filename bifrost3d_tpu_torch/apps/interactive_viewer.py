"""Interactive-lite viewer: a live engine loop in the terminal.

Port of ``bifrost3d_tpu/apps/interactive_viewer.py`` (``frame_to_ansi``,
``TerminalDisplay``, ``TerminalInput``, ``CameraNavigation``,
``RenderingPanel``, ``build_scene``, ``run``, ``main``), the stand-in for
the reference's L5 windowing/driver layer (SURVEY.md §2.6:
Win32Driver/GLFWDriver + SimpleViewer's main loop). The "window" is the
terminal: frames draw as ANSI truecolor half-blocks, and raw-mode stdin
drives the datamodel ``Keyboard`` the way the OS drivers feed it in the
reference.

- An engine tick is mutating (input + camera navigation) → non-mutating
  (Compositor render) → cleanup (change-notification reset), as
  ``Core/Engine.cpp:36-49`` and ``SimpleViewer/main.cpp:298-308``.
- 'p' toggles path tracer <-> preview per camera
  (``SimpleViewer/main.cpp:285-291``); 'g' opens the settings panel.
- WASD/QE translate, arrow keys rotate the camera (CameraHandlers.cpp);
  any camera change restarts that camera's progressive accumulation.
- FPS as an 8-frame moving average of the render time in the status line
  (``SimpleViewer/main.cpp:72-88``).
- 'x' runs the screenshot request→fill→resolve pipeline to a PNG
  (``Scene/Camera.cpp:190-222``).
- 'q' / ESC quits.

The datamodel is host state; the compositor renders on ``device``. A tick
that presents nothing copies nothing to the host: a frame comes back only
to be drawn, and a screenshot only to be saved. Without a terminal the
run prints nothing, as JAX's does.

Run: ``python -m bifrost3d_tpu_torch.apps.interactive_viewer --scene Sphere
--window-size 96x54`` (on the card; ``--device cpu`` for the CPU). Use
``--ticks N --keys "wwp"`` for scripted / headless runs.
"""

from __future__ import annotations

import argparse
import select
import sys
import time

import numpy as np
import torch

from bifrost3d_tpu_torch.core.compositor import Compositor
from bifrost3d_tpu_torch.core.engine import Engine, Window
from bifrost3d_tpu_torch.core.input import Keyboard, Mouse
from bifrost3d_tpu_torch.geometry.creation import (
    make_box,
    make_plane,
    make_sphere,
)
from bifrost3d_tpu_torch.integrator.backend import (
    DenoisedBackend,
    SimpleBackend,
)
from bifrost3d_tpu_torch.integrator.path_tracer import RenderSettings
from bifrost3d_tpu_torch.io.image import save_image
from bifrost3d_tpu_torch.math.quaternion import (
    quat_from_axis_angle,
    quat_mul,
    quat_normalize,
    quat_rotate,
)
from bifrost3d_tpu_torch.math.transform import transform_identity
from bifrost3d_tpu_torch.post.tonemap import (
    EXPOSURE_FIXED,
    EXPOSURE_HISTOGRAM,
    EXPOSURE_LOG_AVERAGE,
    TONEMAP_AGX,
    TONEMAP_FILMIC,
    TONEMAP_KHRONOS_NEUTRAL,
    TONEMAP_LINEAR,
    CameraEffectsSettings,
)
from bifrost3d_tpu_torch.preview.renderer import PreviewBackend
from bifrost3d_tpu_torch.scene.datamodel import SceneData


# -- Terminal "swapchain" -----------------------------------------------------------

def frame_to_ansi(ldr) -> str:
    """LDR [H, W, 3] in [0,1] (numpy, or a tensor on any device) → ANSI
    truecolor half-block string.

    Each character cell shows two vertical pixels: '▀' with the upper
    pixel as foreground and the lower as background.
    """
    if isinstance(ldr, torch.Tensor):
        ldr = ldr.detach().cpu().numpy()
    img = np.clip(np.asarray(ldr) * 255.0, 0, 255).astype(np.uint8)
    h, w, _ = img.shape
    if h % 2:
        img = np.concatenate([img, img[-1:]], axis=0)
        h += 1
    out = []
    for y in range(0, h, 2):
        row = []
        for x in range(w):
            tr, tg, tb = img[y, x]
            br, bg, bb = img[y + 1, x]
            row.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                       f"\x1b[48;2;{br};{bg};{bb}m▀")
        out.append("".join(row) + "\x1b[0m")
    return "\n".join(out)


class TerminalDisplay:
    """Cursor-homed redraw, shown only when stdout is a TTY (or forced)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._first = True

    def present(self, ldr, status: str) -> None:
        if not self.enabled:
            return
        body = frame_to_ansi(ldr)
        prefix = "\x1b[2J" if self._first else ""
        self._first = False
        sys.stdout.write(prefix + "\x1b[H" + body + "\n\x1b[K" + status + "\n")
        sys.stdout.flush()


class TerminalInput:
    """Raw-mode nonblocking stdin → Keyboard taps (the OS-driver analogue)."""

    ARROWS = {"A": "up", "B": "down", "C": "right", "D": "left"}

    def __init__(self):
        self._fd = None
        self._saved = None

    def __enter__(self):
        if sys.stdin.isatty():
            import termios
            import tty
            self._fd = sys.stdin.fileno()
            self._saved = termios.tcgetattr(self._fd)
            tty.setcbreak(self._fd)
        return self

    def __exit__(self, *exc):
        if self._saved is not None:
            import termios
            termios.tcsetattr(self._fd, termios.TCSADRAIN, self._saved)

    def poll(self) -> list[str]:
        """Drain pending keys as a list of names ('a', 'up', 'esc', ...)."""
        if self._fd is None:
            return []
        keys = []
        while select.select([sys.stdin], [], [], 0)[0]:
            ch = sys.stdin.read(1)
            if ch == "\x1b":
                if select.select([sys.stdin], [], [], 0)[0] and \
                        sys.stdin.read(1) == "[":
                    code = sys.stdin.read(1)
                    keys.append(self.ARROWS.get(code, "esc"))
                else:
                    keys.append("esc")
            else:
                keys.append(ch.lower())
        return keys


# -- Camera navigation (CameraHandlers.cpp analogue) ---------------------------------

_Y_AXIS = (0.0, 1.0, 0.0)
_X_AXIS = (1.0, 0.0, 0.0)


class CameraNavigation:
    """Moves the camera's host transform; touches no device."""

    MOVE_SPEED = 1.5       # scene units / second
    TURN_SPEED = 1.2       # radians / second

    def __init__(self, data, camera_uid):
        self.data = data
        self.camera = camera_uid

    def handle(self, keyboard: Keyboard, dt: float) -> None:
        t = self.data.cameras.get_transform(self.camera)
        move = np.zeros(3, np.float32)

        def active(key):
            # Held keys (is_pressed) and tap-release within one tick
            # (was_pressed) both move: scripted and terminal input arrives
            # as taps, a real key-repeat stream as held state.
            return keyboard.is_pressed(key) or keyboard.was_pressed(key)

        if active("w"):
            move[2] += 1.0
        if active("s"):
            move[2] -= 1.0
        if active("d"):
            move[0] += 1.0
        if active("a"):
            move[0] -= 1.0
        if active("e"):
            move[1] += 1.0
        if active("q"):
            move[1] -= 1.0
        yaw = (keyboard.halftaps("right") - keyboard.halftaps("left"))
        pitch = (keyboard.halftaps("down") - keyboard.halftaps("up"))

        if not (move.any() or yaw or pitch):
            return
        rot = t.rotation
        if yaw or pitch:
            def turn(axis, steps):
                return quat_from_axis_angle(
                    torch.tensor(axis),
                    torch.tensor(steps * self.TURN_SPEED * 0.1,
                                 dtype=torch.float32))
            rot = quat_normalize(quat_mul(
                rot, quat_mul(turn(_Y_AXIS, yaw), turn(_X_AXIS, pitch))))
        delta = quat_rotate(rot, torch.from_numpy(move * self.MOVE_SPEED * dt))
        self.data.cameras.set_transform(
            self.camera,
            t._replace(translation=t.translation + delta, rotation=rot))


# -- Rendering settings panel (the ImGui RenderingGUI analogue) ---------------------

_EXPOSURE_NAMES = {EXPOSURE_FIXED: "fixed", EXPOSURE_LOG_AVERAGE: "log-average",
                   EXPOSURE_HISTOGRAM: "histogram"}
_TONEMAP_NAMES = {TONEMAP_LINEAR: "linear", TONEMAP_FILMIC: "filmic",
                  TONEMAP_AGX: "AgX", TONEMAP_KHRONOS_NEUTRAL: "Khronos PBR"}


def _cycle(names, current, d):
    keys = sorted(names)
    return keys[(keys.index(current) + d) % len(keys)]


class RenderingPanel:
    """Live renderer-settings surface, the terminal analogue of the
    reference's ImGui ``RenderingGUI`` (apps/SimpleViewer/GUI/
    RenderingGUI.cpp): renderer selection, bounce count, NEE sample count,
    path regularization, and the camera-effects chain (exposure mode/bias,
    tonemapper, bloom, vignette, film grain), adjusted live; a
    render-settings change restarts that camera's progressive
    accumulation, as in the reference.

    Keys: 'g' opens/closes, up/down select a row, left/right adjust.
    """

    def __init__(self, data, comp, cam, renderer_ids):
        self.open = False
        self.row = 0
        self.data, self.comp, self.cam = data, comp, cam
        self.renderer_ids = renderer_ids

    # -- handles ------------------------------------------------------------------
    def _backend(self):
        return self.comp._backends.get(
            (int(self.cam), self.data.cameras.get_renderer(self.cam)))

    def _settings(self):
        return getattr(self._backend(), "settings", None)

    def _set_setting(self, **kw):
        b = self._backend()
        if b is not None and hasattr(b, "settings"):
            b.settings = b.settings._replace(**kw)
            b.reset()   # a render-settings change restarts accumulation

    def _effects(self):
        return self.comp.camera_effects.get(
            int(self.cam), CameraEffectsSettings.preset())

    def _set_effects(self, **kw):
        self.comp.set_camera_effects(self.cam,
                                     self._effects()._replace(**kw))

    def _adjust_bloom(self, d):
        """left lowers the threshold (more bloom), right raises it; past
        4.0 it becomes inf = off (the reference's convention: bloom is
        active when threshold < inf)."""
        cur = self._effects().bloom_threshold
        if not np.isfinite(cur):
            new = 4.0 if d < 0 else np.inf
        else:
            new = cur + 0.5 * d
            new = np.inf if new > 4.0 else max(0.5, new)
        self._set_effects(bloom_threshold=float(new))

    # -- rows ---------------------------------------------------------------------
    def _rows(self):
        def renderer_row():
            current = self.data.cameras.get_renderer(self.cam)
            ids = [rid for _, rid in self.renderer_ids]
            names = {rid: name for name, rid in self.renderer_ids}

            def adjust(d):
                nxt = ids[(ids.index(current) + d) % len(ids)]
                self.data.cameras.set_renderer(self.cam, nxt)

            return f"renderer: {names.get(current, '?')}", adjust

        rows = [renderer_row()]
        s = self._settings()
        if s is not None:
            rows += [
                (f"max bounces: {s.max_bounce_count}",
                 lambda d: self._set_setting(max_bounce_count=int(
                     np.clip(self._settings().max_bounce_count + d, 0, 16)))),
                (f"NEE samples (RIS): {s.next_event_sample_count}",
                 lambda d: self._set_setting(next_event_sample_count=int(
                     np.clip(self._settings().next_event_sample_count + d,
                             0, 8)))),
                (f"path reg. scale: {s.path_regularization_scale:.2f}",
                 lambda d: self._set_setting(path_regularization_scale=float(
                     max(0.0,
                         self._settings().path_regularization_scale
                         + 0.5 * d)))),
                (f"path reg. decay: {s.path_regularization_decay:.2f}",
                 lambda d: self._set_setting(path_regularization_decay=float(
                     np.clip(self._settings().path_regularization_decay
                             + 0.05 * d, 0.0, 1.0)))),
            ]
        e = self._effects()
        rows += [
            (f"exposure mode: {_EXPOSURE_NAMES[e.exposure_mode]}",
             lambda d: self._set_effects(exposure_mode=_cycle(
                 _EXPOSURE_NAMES, self._effects().exposure_mode, d))),
            (f"exposure bias: {e.log_luminance_bias:+.2f}",
             lambda d: self._set_effects(log_luminance_bias=float(
                 self._effects().log_luminance_bias + 0.25 * d))),
            (f"tonemapper: {_TONEMAP_NAMES[e.tonemapping_mode]}",
             lambda d: self._set_effects(tonemapping_mode=_cycle(
                 _TONEMAP_NAMES, self._effects().tonemapping_mode, d))),
            ("bloom threshold: "
             + ("off" if not np.isfinite(e.bloom_threshold)
                else f"{e.bloom_threshold:.1f}"),
             self._adjust_bloom),
            (f"vignette: {e.vignette:.2f}",
             lambda d: self._set_effects(vignette=float(
                 np.clip(self._effects().vignette + 0.05 * d, 0.0, 1.0)))),
            ("film grain: "
             + ("on" if e.film_grain > 0 else "off"),
             lambda d: self._set_effects(
                 film_grain=0.0 if self._effects().film_grain > 0
                 else 1.0 / 255.0)),
        ]
        return rows

    # -- input / drawing ------------------------------------------------------------
    def handle(self, key: str) -> bool:
        """Consume a key when the panel owns it; returns True if consumed."""
        if key == "g":
            self.open = not self.open
            return True
        if not self.open:
            return False
        rows = self._rows()
        if key == "up":
            self.row = (self.row - 1) % len(rows)
        elif key == "down":
            self.row = (self.row + 1) % len(rows)
        elif key in ("left", "right"):
            rows[self.row][1](1 if key == "right" else -1)
        elif key == "esc":
            self.open = False
        else:
            return False
        return True

    def lines(self):
        if not self.open:
            return []
        out = ["--- rendering settings (g close, up/down select, "
               "left/right adjust) ---"]
        for i, (label, _) in enumerate(self._rows()):
            marker = ">" if i == self.row else " "
            out.append(f" {marker} {label}")
        return out


# -- Built-in datamodel scenes (live-mutable, unlike apps.scenes RenderScenes) ------

def _at(translation):
    return transform_identity()._replace(
        translation=torch.tensor(translation, dtype=torch.float32))


def build_scene(name: str):
    """→ (SceneData, camera UID) of the viewer's Sphere or Box scene; host
    state only."""
    d = SceneData()
    root = d.nodes.create("root")
    d.roots.create("scene", root, environment_tint=(0.68, 0.92, 1.0))

    def place(mesh_uid, mat_uid, translation, node_name="obj"):
        node = d.nodes.create(node_name, _at(translation))
        d.nodes.set_parent(node, root)
        d.models.create(node, mesh_uid, mat_uid)
        return node

    if name.lower() == "sphere":
        sphere = d.meshes.create("sphere", make_sphere(radius=0.6,
                                                       slices=48, stacks=24))
        plane = d.meshes.create("floor", make_plane(size=8.0))
        white = d.materials.create("white", tint=(0.8, 0.8, 0.8),
                                   roughness=0.9)
        red = d.materials.create("red", tint=(0.8, 0.2, 0.15),
                                 roughness=0.3)
        place(plane, white, (0, -0.6, 0), "floor")
        place(sphere, red, (0, 0, 0), "ball")
    elif name.lower() == "box":
        box = d.meshes.create("box", make_box(size=0.8))
        plane = d.meshes.create("floor", make_plane(size=8.0))
        grey = d.materials.create("grey", tint=(0.6, 0.6, 0.6),
                                  roughness=0.8)
        gold = d.materials.create("gold", tint=(1.0, 0.77, 0.33),
                                  roughness=0.15, metallic=1.0)
        place(plane, grey, (0, -0.4, 0), "floor")
        place(box, gold, (0, 0, 0), "box")
    else:
        raise SystemExit(f"unknown scene {name!r} (Sphere, Box)")

    light_node = d.nodes.create("light", _at([1.5, 3.0, -1.5]))
    d.nodes.set_parent(light_node, root)
    d.lights.create_sphere_light(light_node, (120, 120, 120), 0.3)

    cam = d.cameras.create("main", root, transform=_at([0.0, 0.6, -3.0]))
    return d, cam


# -- The app ----------------------------------------------------------------------

def run(scene_name="Sphere", width=96, height=54, ticks=None,
        scripted_keys="", display=None, screenshot_path=None,
        max_bounce=3, *, device):
    """The viewer's engine loop, rendering on ``device`` →
    (frames {camera id: LDR tensor}, SceneData, Compositor)."""
    data, cam = build_scene(scene_name)
    window = Window("bifrost3d_tpu", width, height)
    engine = Engine(window)
    keyboard, mouse = Keyboard(), Mouse()

    comp = Compositor(data, width=width, height=height, device=device)
    pt_id = comp.add_renderer(
        "PathTracer", lambda scene, camera, w, h: SimpleBackend(
            scene, camera, w, h, RenderSettings(max_bounce_count=max_bounce)))
    pv_id = comp.add_renderer(
        "Preview", lambda scene, camera, w, h: PreviewBackend(
            scene, camera, w, h, enable_ssao=False))
    dn_id = comp.add_renderer(
        "Denoised", lambda scene, camera, w, h: DenoisedBackend(
            scene, camera, w, h, RenderSettings(max_bounce_count=max_bounce)))
    data.cameras.set_renderer(cam, pt_id)

    nav = CameraNavigation(data, cam)
    panel = RenderingPanel(data, comp, cam, [
        ("PathTracer", pt_id), ("Preview", pv_id), ("Denoised", dn_id)])
    if display is None:
        display = sys.stdout.isatty()
    term = TerminalDisplay(display)
    fps_window = []
    scripted = list(scripted_keys)
    state = {"frames": {}, "input": None}

    def on_input(engine):
        dt = engine.time.delta
        keys = list(state["input"].poll()) if state["input"] else []
        if scripted:
            k = scripted.pop(0)
            if k:       # "" = scripted no-op tick
                keys.append(k)
        for k in keys:
            if k == "q" or (k == "esc" and not panel.open):
                engine.request_quit()
            elif panel.handle(k):
                pass    # the settings panel consumed the key (RenderingGUI)
            elif k == "p":
                # SimpleViewer main.cpp:285-291 renderer toggle.
                current = data.cameras.get_renderer(cam)
                data.cameras.set_renderer(
                    cam, pv_id if current == pt_id else pt_id)
            elif k == "x":
                data.cameras.request_screenshot(cam, content="ldr")
            else:
                keyboard.press(k)
                keyboard.release(k)
        nav.handle(keyboard, max(dt, 1e-3))

    def on_render(engine):
        t0 = time.perf_counter()
        state["frames"] = comp.render()
        frame = state["frames"].get(int(cam))
        if frame is None:
            return
        fps_window.append(time.perf_counter() - t0)
        del fps_window[:-8]  # 8-frame moving average (main.cpp:72-88)
        fps = len(fps_window) / max(sum(fps_window), 1e-6)
        for shot in data.cameras.resolve_screenshot(cam):
            if screenshot_path:
                # LDR screenshots are already tonemapped.
                save_image(screenshot_path, shot["image"],
                           from_linear=shot["content"] == "hdr")
        backend = comp._backends.get(
            (int(cam), data.cameras.get_renderer(cam)))
        accum = getattr(backend, "accumulations", 0)
        name = comp.renderers.get_name(data.cameras.get_renderer(cam))
        window.set_name(f"bifrost3d_tpu | {name} | {fps:5.1f} fps | "
                        f"{accum} spp")
        status = (window.name
                  + " | WASD move, arrows turn, P toggle, G settings, "
                    "X shot, Q quit")
        panel_text = panel.lines()
        if panel_text:
            status += "\n" + "\n\x1b[K".join(panel_text)
        term.present(frame, status)

    def on_cleanup(engine):
        data.reset_change_notifications()
        keyboard.per_frame_reset()
        mouse.per_frame_reset()

    engine.add_mutating_callback(on_input)
    engine.add_non_mutating_callback(on_render)
    engine.add_tick_cleanup_callback(on_cleanup)

    if display and sys.stdin.isatty():
        with TerminalInput() as state["input"]:
            engine.run(max_ticks=ticks)
    else:
        engine.run(max_ticks=ticks if ticks is not None else 64)
    return state["frames"], data, comp


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--scene", default="Sphere", help="Sphere or Box")
    p.add_argument("--window-size", default="96x54")
    p.add_argument("--ticks", type=int, default=None,
                   help="stop after N engine ticks (default: run until Q)")
    p.add_argument("--keys", default="", help="scripted key sequence")
    p.add_argument("--screenshot", default="interactive_shot.png")
    p.add_argument("--max-bounce", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda or cpu)")
    args = p.parse_args(argv)
    w, h = (int(v) for v in args.window_size.split("x"))
    run(args.scene, w, h, ticks=args.ticks, scripted_keys=args.keys,
        screenshot_path=args.screenshot, max_bounce=args.max_bounce,
        device=torch.device(args.device))


if __name__ == "__main__":
    main()
