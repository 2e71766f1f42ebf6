"""Five places where the port answered otherwise than the JAX package, each
held against it on the CPU: the shading models a replaced material table
holds, in-place writes to a scene's tensors, the name of the megakernel's
BVH branch, the viewer's camera flags, and the fields of RenderSettings."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bifrost3d_tpu.apps import simple_viewer as jax_viewer
from bifrost3d_tpu.apps.scenes import create_cornell_box as jax_cornell_box
from bifrost3d_tpu.integrator import pallas_mesh as jpm
from bifrost3d_tpu.integrator import path_tracer as jpt

from bifrost3d_tpu_torch.apps import simple_viewer
from bifrost3d_tpu_torch.integrator import pallas_mesh as tpm
from bifrost3d_tpu_torch.integrator import path_tracer as tpt
from bifrost3d_tpu_torch.scene.camera import camera_from_numpy
from bifrost3d_tpu_torch.scene.render_scene import render_scene_from_numpy
from torch_parity import assert_statistical_gate, camera_arrays, scene_arrays

RES = 24
BOUNCES = 2


@pytest.fixture(scope="module")
def cornell():
    """(JAX scene, JAX camera, port scene arrays, port camera)."""
    scene, cam = jax_cornell_box()
    return (scene, cam, scene_arrays(scene),
            camera_from_numpy(camera_arrays(cam), device="cpu"))


def _jax_frame(scene, cam):
    settings = jpt.settings_for_scene(scene, max_bounce_count=BOUNCES)
    return np.asarray(jpt.render_sample(scene, cam, RES, RES, jnp.uint32(0),
                                        settings))


def _megakernel_frame(scene, cam, accumulation=0):
    """The plain megakernel's frame (render_mesh_megakernel on the CPU)."""
    settings = tpt.RenderSettings(max_bounce_count=BOUNCES)
    img, _ = tpm.render_mesh_megakernel(scene, cam, RES, RES, accumulation,
                                        settings)
    return img


# -- shading models after a _replace of the materials -----------------------------

@pytest.fixture(scope="module")
def diffuse_cornell(cornell):
    """Cornell with every material turned Diffuse by a _replace, in both
    packages (the port's scene built with the Default set first), and
    JAX's frame of it."""
    jscene, jcam, arrays, cam = cornell
    jdiffuse = jscene._replace(materials=jscene.materials._replace(
        shading_model=jnp.ones_like(jscene.materials.shading_model)))
    scene = render_scene_from_numpy(arrays, device="cpu")
    assert scene.shading_models == (0,)
    diffuse = scene._replace(materials=scene.materials._replace(
        shading_model=torch.ones_like(scene.materials.shading_model)))
    return diffuse, cam, _jax_frame(jdiffuse, jcam)


@pytest.mark.parametrize("path", ["wavefront", "megakernel"])
def test_replaced_diffuse_materials_match_jax(diffuse_cornell, path):
    scene, cam, ref = diffuse_cornell
    assert scene.shading_models == (1,)
    settings = tpt.RenderSettings(max_bounce_count=BOUNCES)
    assert tpm.mesh_megakernel_eligible(scene, settings)
    if path == "wavefront":
        img = tpt.render_sample(scene, cam, RES, RES, 0, settings)
    else:
        img = _megakernel_frame(scene, cam)
    assert_statistical_gate(img.numpy(), ref)


def test_replaced_transmissive_material_raises(cornell):
    """A material turned Transmissive by a _replace: the megakernel refuses
    the scene for the same reasons as JAX's, and the wavefront renders it
    (the model is ported; it raised before) as JAX renders it, under the
    statistical gate."""
    jscene, jcam, arrays, cam = cornell
    scene = render_scene_from_numpy(arrays, device="cpu")
    models = scene.materials.shading_model.clone()
    models[0] = 2
    scene = scene._replace(materials=scene.materials._replace(
        shading_model=models))
    jscene = jscene._replace(materials=jscene.materials._replace(
        shading_model=jscene.materials.shading_model.at[0].set(2)))
    reasons = tpm.megakernel_ineligibility_reasons(scene, tpt.RenderSettings())
    assert reasons == jpm.megakernel_ineligibility_reasons(
        jscene, jpt.RenderSettings())
    assert "Transmissive shading model" in reasons
    assert scene.shading_models == (0, 2)
    img = tpt.render_sample(scene, cam, RES, RES, 0,
                            tpt.RenderSettings(max_bounce_count=BOUNCES))
    assert_statistical_gate(img.numpy(), _jax_frame(jscene, jcam))


# -- in-place writes ----------------------------------------------------------------

def test_in_place_coat_write_is_seen(cornell):
    """A coat added in place after a first frame renders as a freshly built
    coated scene does, and as JAX renders the same coated scene."""
    jscene, jcam, arrays, cam = cornell
    scene = render_scene_from_numpy(arrays, device="cpu")
    stale = _megakernel_frame(scene, cam)
    with torch.no_grad():
        scene.materials.coat.add_(0.8)
    img = _megakernel_frame(scene, cam)
    coated = dict(arrays, materials=dict(arrays["materials"]))
    coated["materials"]["coat"] = arrays["materials"]["coat"] + np.float32(0.8)
    fresh = _megakernel_frame(render_scene_from_numpy(coated, device="cpu"),
                              cam)
    assert torch.equal(img, fresh)
    assert not torch.equal(img, stale)
    jcoated = jscene._replace(materials=jscene.materials._replace(
        coat=jscene.materials.coat + 0.8))
    assert_statistical_gate(img.numpy(), _jax_frame(jcoated, jcam))


def test_in_place_geometry_write_is_seen(cornell):
    """Triangles moved in place (``tri_verts.copy_``) after a first frame
    render as a freshly built scene of the moved triangles does."""
    _, _, arrays, cam = cornell
    scene = render_scene_from_numpy(arrays, device="cpu")
    stale = _megakernel_frame(scene, cam)
    moved = arrays["tri_verts"] * np.float32(0.8)
    with torch.no_grad():
        scene.tri_verts.copy_(torch.tensor(moved))
    img = _megakernel_frame(scene, cam)
    fresh = _megakernel_frame(render_scene_from_numpy(
        dict(arrays, tri_verts=moved, tri_components=None), device="cpu"),
        cam)
    assert torch.equal(img, fresh)
    assert not torch.equal(img, stale)


# -- explain_render_path --------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_large_scene():
    """A 2,304-triangle sphere under a sphere light, built by the JAX
    package: over MAX_TRIS, so its megakernel takes the BVH branch."""
    from bifrost3d_tpu.geometry.creation import make_plane, make_sphere
    from bifrost3d_tpu.lights.types import LIGHT_SPHERE, LightArray
    from bifrost3d_tpu.scene.materials import MaterialArray, dielectric
    from bifrost3d_tpu.scene.render_scene import build_render_scene
    from bifrost3d_tpu.apps.scenes import _trs
    scene = build_render_scene(
        [(make_plane(size=4.0), 0, _trs((0, -0.5, 0))),
         (make_sphere(radius=0.5, slices=48, stacks=24), 0, None)],
        MaterialArray.build([dielectric((0.7, 0.7, 0.7), 0.5)]),
        LightArray.build([{"kind": LIGHT_SPHERE, "position": (1.0, 2.0, -1.0),
                           "radius": 0.3, "power": (50.0,) * 3}]))
    return scene


@pytest.mark.parametrize("size", ["dense", "hier"])
def test_explain_render_path_names_the_trace_as_jax(cornell, jax_large_scene,
                                                    monkeypatch, size):
    jscene = cornell[0] if size == "dense" else jax_large_scene
    scene = render_scene_from_numpy(scene_arrays(jscene), device="cpu")
    assert (int(scene.tri_verts.shape[0]) > tpm.MAX_TRIS) == (size == "hier")
    # Both as on their cards: the JAX package on a TPU, the port on CUDA.
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(tpt, "_device_kind", lambda s: "cuda")
    got = tpt.explain_render_path(scene, tpt.RenderSettings())
    assert got == jpt.explain_render_path(jscene, jpt.RenderSettings())
    assert got == {"dense": "megakernel",
                   "hier": "megakernel (hier: cluster-BVH DMA trace)"}[size]


# -- the viewer's camera flags ------------------------------------------------------

class _Rendered(Exception):
    """Raised by a stand-in render_progressive once it has the camera."""


def _camera_of(main, module, monkeypatch, argv):
    """The camera ``main(argv)`` hands to ``module.render_progressive``."""
    seen = {}

    def capture(scene, camera, *args, **kwargs):
        seen["camera"] = camera
        raise _Rendered

    monkeypatch.setattr(module, "render_progressive", capture)
    with pytest.raises(_Rendered):
        main(argv)
    return seen["camera"]


@pytest.mark.parametrize("flags", [
    ["--camera-position", "0.5,1,-3", "--camera-target", "0,0.2,0"],
    ["--camera-position", "1,2,-4"],
    ["--camera-target", "0.1,-0.2,0.3", "--window-size", "64x32"]])
def test_viewer_camera_flags_match_jax(monkeypatch, flags):
    argv = ["--scene", "CornellBox", "-n", "1", "-o", "unused.png"] + flags
    jcam = _camera_of(jax_viewer.main, jpt, monkeypatch, argv)
    cam = _camera_of(simple_viewer.main, tpt, monkeypatch,
                     argv + ["--device", "cpu"])
    ref = camera_arrays(jcam)
    got = {"translation": cam.transform.translation,
           "rotation": cam.transform.rotation, "scale": cam.transform.scale,
           "projection": cam.projection,
           "inverse_projection": cam.inverse_projection}
    for name, value in got.items():
        np.testing.assert_allclose(value.numpy(), ref[name], rtol=1e-6,
                                   atol=1e-6, err_msg=name)


# -- RenderSettings ---------------------------------------------------------------------

def test_render_settings_take_jax_arguments():
    jax_settings = jpt.RenderSettings(
        5, 2, 0.0, 0.5, 3.0, 16.0, True, 6, 3, False, (0, 1), 1, False,
        True, True)
    values = tuple(jax_settings)
    assert tpt.RenderSettings._fields == jpt.RenderSettings._fields
    assert tuple(tpt.RenderSettings(*values)) == values
    assert tuple(tpt.RenderSettings(**jax_settings._asdict())) == values
    assert tuple(tpt.RenderSettings()) == tuple(jpt.RenderSettings())


def test_accepted_settings_change_no_frame(cornell):
    """The fields the port accepts without using them render the frame they
    render without them."""
    _, _, arrays, cam = cornell
    scene = render_scene_from_numpy(arrays, device="cpu")
    plain = tpt.RenderSettings(max_bounce_count=BOUNCES)
    accepted = plain._replace(path_regularization_decay=0.5,
                              shading_models_present=(0,),
                              remat_bounces=True, detached_replay_vjp=True)
    torch.testing.assert_close(
        tpt.render_sample(scene, cam, 8, 8, 0, accepted),
        tpt.render_sample(scene, cam, 8, 8, 0, plain), rtol=0.0, atol=0.0)
