"""Compositor: per-camera renderer dispatch + post chain + screenshots.

Port of ``bifrost3d_tpu/core/compositor.py`` (``Renderers``,
``Compositor``), the counterpart of ``DX11Renderer/Compositor.cpp:203-327``
and the renderer registry of ``Core/Renderer.h:31-59``: renderers register
by name and get an ID; each camera selects a renderer by ID; every frame
the compositor syncs the datamodel (``handle_updates``), renders each
camera in z-order through its selected renderer, fills HDR screenshots,
applies the camera-effects post chain (exposure with eye adaptation →
bloom → tonemap), and fills LDR screenshots.

A "renderer" is a factory producing a progressive backend (``render()`` →
HDR image tensor, ``reset()``); all backends share one ``SceneSync`` on
the compositor's device, so a datamodel change rebuilds the device scene
once and restarts all progressive accumulation (Renderer.cpp:1202-1204).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from bifrost3d_tpu_torch.post.pipeline import process_stateful
from bifrost3d_tpu_torch.post.tonemap import CameraEffectsSettings
from bifrost3d_tpu_torch.scene.datamodel import SceneData, SceneSync


class Renderers:
    """Name registry handing out renderer IDs (``Core/Renderer.h:31-59``)."""

    def __init__(self):
        self._names: List[str] = []

    def create(self, name: str) -> int:
        self._names.append(name)
        return len(self._names) - 1

    def get_name(self, renderer_id: int) -> str:
        return self._names[renderer_id]

    def __len__(self) -> int:
        return len(self._names)

    def __iter__(self):
        return iter(range(len(self._names)))


# factory(render_scene, pinhole_camera, width, height) -> backend
RendererFactory = Callable[..., object]


class Compositor:
    """Orchestrates all renderers over all cameras each tick, on
    ``device``."""

    def __init__(self, data: SceneData, width: int = 512, height: int = 512,
                 *, device):
        self.data = data
        self.sync = SceneSync(data, device=device)
        self.device = self.sync.device
        self.renderers = Renderers()
        self.width = width
        self.height = height
        self._factories: Dict[int, RendererFactory] = {}
        self._backends: Dict[Tuple[int, int], object] = {}
        self._scene = None
        self.camera_effects: Dict[int, CameraEffectsSettings] = {}
        # Per-camera eye-adaptation exposure (-1 = no history; afterwards
        # the 0-d tensor process_stateful returns, kept on the device so a
        # tick makes no host sync for it) and the tick delta handed to it.
        self._exposure_state: Dict[int, object] = {}
        self._delta_time: float = 1.0 / 60.0

    def add_renderer(self, name: str, factory: RendererFactory) -> int:
        """Register a renderer; returns its ID for Cameras.set_renderer."""
        renderer_id = self.renderers.create(name)
        self._factories[renderer_id] = factory
        return renderer_id

    def set_camera_effects(self, camera_uid, settings: CameraEffectsSettings):
        self.camera_effects[int(camera_uid)] = settings

    def resize(self, width: int, height: int) -> None:
        if (width, height) != (self.width, self.height):
            self.width, self.height = width, height
            self._backends.clear()

    def _backend_for(self, camera_uid, renderer_id: int):
        key = (int(camera_uid), renderer_id)
        backend = self._backends.get(key)
        if backend is None:
            pinhole = self.data.cameras.to_pinhole(camera_uid,
                                                   device=self.device)
            backend = self._factories[renderer_id](
                self._scene, pinhole, self.width, self.height)
            self._backends[key] = backend
        return backend

    def render(self):
        """One frame over all cameras → {camera_uid: LDR image}.

        Mirrors Compositor::render: handle_updates → per-camera render by
        z-order → HDR screenshot → camera effects → LDR screenshot.
        """
        scene = self.sync.handle_updates()
        if scene is not self._scene:
            # Datamodel changed: new backends against the new device scene
            # restart progressive accumulation.
            self._scene = scene
            self._backends.clear()
        elif self.data.cameras.changes.any_changes:
            # Camera-only change: only the touched cameras' backends
            # restart, without a device-scene rebuild.
            for uid in self.data.cameras.changes.get_changed_resources():
                for key in [k for k in self._backends if k[0] == int(uid)]:
                    del self._backends[key]

        cameras = self.data.cameras
        frames = {}
        for camera_uid in cameras.get_z_sorted_ids():
            renderer_id = cameras.get_renderer(camera_uid)
            if renderer_id not in self._factories:
                continue
            backend = self._backend_for(camera_uid, renderer_id)
            hdr = backend.render()
            iterations = getattr(backend, "accumulations", 1)
            if cameras.is_screenshot_requested(camera_uid):
                req = cameras._get(camera_uid).screenshot_request
                if req.get("content", "hdr") == "hdr":
                    cameras.fill_screenshot(camera_uid, hdr, iterations)
            settings = self.camera_effects.get(
                int(camera_uid), CameraEffectsSettings.preset())
            # Temporal eye adaptation (CameraEffects.cpp:456-469): per-
            # camera exposure state lerped toward the frame's target.
            prev = self._exposure_state.get(int(camera_uid), -1.0)
            ldr, exposure = process_stateful(
                hdr, settings, iterations, prev, self._delta_time)
            self._exposure_state[int(camera_uid)] = exposure
            if cameras.is_screenshot_requested(camera_uid):
                req = cameras._get(camera_uid).screenshot_request
                if req.get("content", "hdr") == "ldr":
                    cameras.fill_screenshot(camera_uid, ldr, iterations)
            frames[int(camera_uid)] = ldr
        return frames

    def attach(self, engine) -> None:
        """Wire into the engine tick: render as non-mutating work, the
        change-notification reset as tick cleanup (SimpleViewer
        main.cpp:298-308, Compositor render callback main.cpp:452). The
        frame delta is read from ``engine`` itself, so eye adaptation
        tracks the real frame time however the tick calls back."""
        def _render(*_):
            dt = getattr(engine.time, "delta", 0.0)
            if dt:
                self._delta_time = float(dt)
            self.render()

        engine.add_non_mutating_callback(_render)
        engine.add_tick_cleanup_callback(
            lambda *_: self.data.reset_change_notifications())
