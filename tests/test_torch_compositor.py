"""The port's Compositor against ``tests/test_compositor.py`` and JAX's.

The registry, progressive accumulation, the scene-change reset, the
screenshot pipeline, z-order, the engine wiring and textures mirror
``tests/test_compositor.py`` on the port (CPU tensors, where every
kernel wrapper takes its plain version); a camera move restarts only
that camera's backends and keeps the device scene; a screenshot keeps the
frame of its fill; and one 16 × 12, 1-bounce frame of the compositor is
held against JAX's under the statistical gate.
"""

import numpy as np
import torch

from bifrost3d_tpu.core.compositor import Compositor as JaxCompositor
from bifrost3d_tpu.integrator.backend import SimpleBackend as JaxSimpleBackend
from bifrost3d_tpu.integrator.path_tracer import (
    RenderSettings as JaxRenderSettings,
)

from bifrost3d_tpu_torch.core.compositor import Compositor, Renderers
from bifrost3d_tpu_torch.core.engine import Engine
from bifrost3d_tpu_torch.geometry.creation import make_plane
from bifrost3d_tpu_torch.integrator.backend import SimpleBackend
from bifrost3d_tpu_torch.integrator.path_tracer import RenderSettings
from bifrost3d_tpu_torch.io.texture import FILTER_NONE
from bifrost3d_tpu_torch.math.quaternion import quat_from_axis_angle
from bifrost3d_tpu_torch.math.transform import transform_identity
from bifrost3d_tpu_torch.post.tonemap import CameraEffectsSettings
from bifrost3d_tpu_torch.preview.renderer import PreviewBackend
from bifrost3d_tpu_torch.scene.datamodel import SceneData
from test_torch_datamodel import JAX, PORT, _at
from torch_parity import assert_statistical_gate

W = H = 24
CPU = torch.device("cpu")


def make_scene(pkg=PORT):
    d = pkg.dm.SceneData()
    root = d.nodes.create("root")
    d.roots.create("scene", root, environment_tint=(0.2, 0.3, 0.4))
    mesh = d.meshes.create("sphere", pkg.creation.make_sphere(radius=0.5))
    mat = d.materials.create("grey", tint=(0.5, 0.5, 0.5), roughness=0.6)
    node = d.nodes.create("obj")
    d.nodes.set_parent(node, root)
    d.models.create(node, mesh, mat)
    light_node = d.nodes.create("light", _at(pkg, [0.0, 3.0, 0.0]))
    d.lights.create_sphere_light(light_node, (50, 50, 50), 0.3)
    cam = d.cameras.create("main", root, transform=_at(pkg, [0.0, 0.0, -2.5]))
    return d, mat, cam


def make_compositor(d, bounces=2):
    comp = Compositor(d, width=W, height=H, device=CPU)
    pt_id = comp.add_renderer(
        "PathTracer",
        lambda scene, cam, w, h: SimpleBackend(
            scene, cam, w, h, RenderSettings(max_bounce_count=bounces)))
    pv_id = comp.add_renderer(
        "Preview",
        lambda scene, cam, w, h: PreviewBackend(scene, cam, w, h,
                                                enable_ssao=False))
    return comp, pt_id, pv_id


def test_registry_names_and_ids():
    r = Renderers()
    a = r.create("PathTracer")
    b = r.create("Preview")
    assert (a, b) == (0, 1)
    assert r.get_name(b) == "Preview"
    assert list(r) == [0, 1]


def test_render_selected_renderer_and_progressive_accumulation():
    d, mat, cam = make_scene()
    comp, pt_id, pv_id = make_compositor(d)
    d.cameras.set_renderer(cam, pt_id)
    d.reset_change_notifications()

    frames = comp.render()
    assert int(cam) in frames
    ldr = frames[int(cam)]
    assert ldr.shape == (H, W, 3) and ldr.device == CPU
    assert bool(torch.isfinite(ldr).all())
    backend = comp._backends[(int(cam), pt_id)]
    assert backend.accumulations == 1
    comp.render()
    assert backend.accumulations == 2

    d.cameras.set_renderer(cam, pv_id)
    comp.render()
    assert isinstance(comp._backends[(int(cam), pv_id)], PreviewBackend)


def test_scene_change_resets_accumulation():
    d, mat, cam = make_scene()
    comp, pt_id, _ = make_compositor(d)
    d.cameras.set_renderer(cam, pt_id)
    d.reset_change_notifications()
    comp.render()
    comp.render()
    assert comp._backends[(int(cam), pt_id)].accumulations == 2
    d.materials.set_tint(mat, (0.9, 0.1, 0.1))
    comp.render()
    assert comp._backends[(int(cam), pt_id)].accumulations == 1


def test_camera_move_restarts_only_that_camera():
    d, mat, cam = make_scene()
    comp, pt_id, pv_id = make_compositor(d, bounces=1)
    cam2 = d.cameras.create("pip", d.cameras._get(cam).scene_root,
                            transform=d.cameras.get_transform(cam),
                            z_index=1)
    d.cameras.set_renderer(cam, pt_id)
    d.cameras.set_renderer(cam2, pt_id)
    comp.render()
    d.reset_change_notifications()
    comp.render()
    scene = comp.sync.handle_updates()
    t = d.cameras.get_transform(cam)
    d.cameras.set_transform(cam, t._replace(
        translation=t.translation + torch.tensor([0.0, 0.0, 0.25])))
    comp.render()
    assert comp.sync.handle_updates() is scene
    assert comp._backends[(int(cam), pt_id)].accumulations == 1
    assert comp._backends[(int(cam2), pt_id)].accumulations == 3


def test_screenshot_pipeline_hdr_and_ldr():
    d, mat, cam = make_scene()
    comp, pt_id, _ = make_compositor(d)
    d.cameras.set_renderer(cam, pt_id)
    d.reset_change_notifications()

    d.cameras.request_screenshot(cam, content="hdr",
                                 minimum_iteration_count=2)
    comp.render()
    assert d.cameras.is_screenshot_requested(cam)
    comp.render()
    held = comp._backends[(int(cam), pt_id)].buffer.clone()
    comp._backends[(int(cam), pt_id)].buffer.add_(1.0)
    comp.render()                   # later ticks leave the shot as it was
    shots = d.cameras.resolve_screenshot(cam)
    assert len(shots) == 1 and shots[0]["content"] == "hdr"
    assert shots[0]["iterations"] == 2
    assert shots[0]["image"].shape == (H, W, 3)
    assert torch.equal(shots[0]["image"], held)

    d.cameras.request_screenshot(cam, content="ldr")
    comp.render()
    (shot,) = d.cameras.resolve_screenshot(cam)
    assert float(shot["image"].min()) >= 0.0
    assert float(shot["image"].max()) <= 1.0


def test_z_order_and_multiple_cameras():
    d, mat, cam = make_scene()
    comp, pt_id, pv_id = make_compositor(d)
    cam2 = d.cameras.create("pip", d.cameras._get(cam).scene_root,
                            transform=d.cameras.get_transform(cam),
                            z_index=-1)
    d.cameras.set_renderer(cam, pt_id)
    d.cameras.set_renderer(cam2, pv_id)
    ids = d.cameras.get_z_sorted_ids()
    assert ids[0] == cam2
    frames = comp.render()
    assert list(frames) == [int(cam2), int(cam)]


def test_engine_attach_full_tick():
    d, mat, cam = make_scene()
    comp, pt_id, _ = make_compositor(d)
    d.cameras.set_renderer(cam, pt_id)
    comp.set_camera_effects(cam, CameraEffectsSettings.linear())

    engine = Engine()
    engine.add_mutating_callback(lambda *_: None)
    comp.attach(engine)
    engine.do_tick(0.016)
    assert not d.any_changes
    engine.do_tick(0.016)
    assert comp._backends[(int(cam), pt_id)].accumulations == 2
    assert comp._delta_time == 0.016
    assert isinstance(comp._exposure_state[int(cam)], torch.Tensor)


def test_datamodel_textures_flow_into_render():
    d = SceneData()
    root = d.nodes.create("root")
    d.roots.create("scene", root, environment_tint=(0.6, 0.6, 0.6))
    checker = np.zeros((2, 2, 4), np.float32)
    checker[..., 3] = 0.8
    checker[0, 0, 0] = checker[1, 1, 0] = 1.0
    checker[0, 1, 2] = checker[1, 0, 2] = 1.0
    img = d.images.create("checker", checker)
    tex = d.textures.create(img, magnification_filter=FILTER_NONE)
    mesh = d.meshes.create("floor", make_plane(size=2.0))
    mat = d.materials.create("floor", tint=(1.0, 1.0, 1.0), roughness=0.9,
                             tint_roughness_texture=tex)
    node = d.nodes.create("obj")
    d.nodes.set_parent(node, root)
    d.models.create(node, mesh, mat)
    light_node = d.nodes.create("light", transform_identity()._replace(
        translation=torch.tensor([0.0, 3.0, 0.0])))
    d.lights.create_sphere_light(light_node, (60, 60, 60), 0.3)
    cam = d.cameras.create("main", root, transform=transform_identity()
                           ._replace(translation=torch.tensor([0.0, 1.2, 0.0]),
                                     rotation=quat_from_axis_angle(
                                         torch.tensor([1.0, 0.0, 0.0]),
                                         torch.tensor(np.pi / 2))))
    comp = Compositor(d, width=W, height=H, device=CPU)
    pt = comp.add_renderer(
        "PathTracer",
        lambda scene, camx, w, h: SimpleBackend(
            scene, camx, w, h, RenderSettings(max_bounce_count=1)))
    d.cameras.set_renderer(cam, pt)
    ldr = comp.render()[int(cam)]
    assert bool(torch.isfinite(ldr).all())
    red = int((ldr[..., 0] > ldr[..., 2] + 0.05).sum())
    blue = int((ldr[..., 2] > ldr[..., 0] + 0.05).sum())
    assert red > 10 and blue > 10, (red, blue)


def test_compositor_frame_matches_jax():
    """16 × 12, 1 bounce, 4 ticks through either compositor: the LDR
    frames under the statistical gate, and the HDR screenshots."""
    w, h, ticks = 16, 12, 4
    out = {}
    for key, pkg in (("port", PORT), ("jax", JAX)):
        d, _, cam = make_scene(pkg)
        if key == "port":
            comp = Compositor(d, width=w, height=h, device=CPU)
            factory = (lambda scene, c, ww, hh: SimpleBackend(
                scene, c, ww, hh, RenderSettings(max_bounce_count=1)))
        else:
            comp = JaxCompositor(d, width=w, height=h)
            factory = (lambda scene, c, ww, hh: JaxSimpleBackend(
                scene, c, ww, hh, JaxRenderSettings(max_bounce_count=1)))
        d.cameras.set_renderer(cam, comp.add_renderer("PathTracer", factory))
        d.cameras.request_screenshot(cam, content="hdr",
                                     minimum_iteration_count=ticks)
        for _ in range(ticks):
            frames = comp.render()
            d.reset_change_notifications()
        (shot,) = d.cameras.resolve_screenshot(cam)
        out[key] = [np.asarray(x) for x in (frames[int(cam)], shot["image"])]
    for port, ref in zip(out["port"], out["jax"]):
        assert port.shape == (h, w, 3)
        assert ref.mean() > 1e-3
        assert_statistical_gate(port, ref)
