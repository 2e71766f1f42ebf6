"""The viewer's nine scenes on the port: JAX's names in JAX's order, the
four builders of the Transmissive and material slice against JAX's array
for array, every builder and ``path_rng_4d`` called with JAX's arguments,
and every scene rendered through ``simple_viewer --device cpu``. With
``SHADERBALL_PATH`` pointing at a two-node glTF that the test writes, the
port's MaterialScene loads the shader ball as JAX's does.

A builder takes JAX's parameters in JAX's order; the port's own
(``device`` among them) are keyword-only after them. Before, the port's
``create_cornell_box(aspect=1.0, *, device)`` bound a positional map to
``aspect``, ``create_sphere_scene`` and ``create_opacity_scene`` took a
second positional parameter JAX's do not have, and ``path_rng_4d`` named
its first parameter ``accumulation`` where JAX's says
``accumulation_count``.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifrost3d_tpu.apps import scenes as jax_scenes
from bifrost3d_tpu.integrator import path_tracer as jpt
from bifrost3d_tpu.sampling import sobol as jsobol

from bifrost3d_tpu_torch.apps import scenes as port_scenes
from bifrost3d_tpu_torch.apps import simple_viewer
from bifrost3d_tpu_torch.integrator import pallas_mesh as tpm
from bifrost3d_tpu_torch.integrator import path_tracer as tpt
from bifrost3d_tpu_torch.sampling import sobol as tsobol
from bifrost3d_tpu_torch.scene.render_scene import render_scene_from_numpy
from bifrost3d_tpu_torch.scene.camera import camera_from_numpy
from test_torch_megakernel_extras import _assert_same_scene
from torch_parity import (assert_statistical_gate, camera_arrays,
                          scene_arrays, write_shader_ball)

NEW = ("MaterialScene", "MaterialSceneLegacy", "Glass", "Test")


def test_scenes_are_jax_scenes_in_jax_order():
    assert list(port_scenes.SCENES) == list(jax_scenes.SCENES)


@pytest.mark.parametrize("name", NEW)
def test_new_builders_match_jax(name, tmp_path, monkeypatch):
    # MaterialScene's sphere fallback, whatever the machine holds at either
    # package's default shader-ball path.
    absent = str(tmp_path / "absent" / "Shaderball.gltf")
    monkeypatch.setattr(jax_scenes, "SHADERBALL_PATH", absent)
    monkeypatch.setattr(port_scenes, "SHADERBALL_PATH", absent)
    jscene, jcam = jax_scenes.SCENES[name]()
    ref = render_scene_from_numpy(scene_arrays(jscene), device="cpu")
    scene, cam = port_scenes.SCENES[name](device="cpu")
    _assert_same_scene(scene, ref)
    for field in ref.lights._fields:
        np.testing.assert_allclose(getattr(scene.lights, field).numpy(),
                                   getattr(ref.lights, field).numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=field)
    assert scene.shading_models == ref.shading_models
    jarr = camera_arrays(jcam)
    np.testing.assert_allclose(cam.transform.translation.numpy(),
                               jarr["translation"], atol=1e-6)
    np.testing.assert_allclose(cam.transform.rotation.numpy(),
                               jarr["rotation"], atol=1e-6)
    np.testing.assert_allclose(cam.inverse_projection.numpy(),
                               jarr["inverse_projection"], rtol=1e-6)
    # Which path each takes on a card: the material scenes the
    # megakernel's BVH branch (over 1,024 triangles, a NEAREST checker
    # floor), Glass and Test the wavefront for their Transmissive model.
    reasons = tpm.megakernel_ineligibility_reasons(scene, tpt.RenderSettings())
    if name.startswith("Material"):
        assert reasons == [] and scene.tri_verts.shape[0] > tpm.MAX_TRIS
    else:
        assert reasons == ["Transmissive shading model"]


def _positional(fn):
    return [(p.name, p.default) for p in
            inspect.signature(fn).parameters.values()
            if p.kind is p.POSITIONAL_OR_KEYWORD]


@pytest.mark.parametrize("name", list(jax_scenes.SCENES))
def test_builders_take_jax_arguments(name):
    """JAX's positional parameters, names and defaults, in JAX's order;
    ``device`` keyword-only. Then calls with JAX's arguments by position
    and by keyword build the same scene."""
    jax_fn, port_fn = jax_scenes.SCENES[name], port_scenes.SCENES[name]
    jax_fn = getattr(jax_fn, "__wrapped__", jax_fn)
    assert _positional(port_fn) == _positional(jax_fn)
    device = inspect.signature(port_fn).parameters["device"]
    assert device.kind is device.KEYWORD_ONLY
    if name != "CornellBox":
        return
    env = np.full((4, 8, 3), 0.5, np.float32)
    by_position, _ = port_fn(env, 1.5, device="cpu")
    by_keyword, cam = port_fn(environment_map=env, aspect=1.5, device="cpu")
    for scene in (by_position, by_keyword):
        np.testing.assert_array_equal(scene.environment.image.numpy(), env)
    jscene, jcam = jax_scenes.create_cornell_box(env, 1.5)
    np.testing.assert_allclose(cam.inverse_projection.numpy(),
                               camera_arrays(jcam)["inverse_projection"],
                               rtol=1e-6)


def test_path_rng_4d_takes_jax_arguments():
    rng = np.random.default_rng(3)
    hashes = rng.integers(0, 2**32, size=256, dtype=np.uint64)
    dims = (np.arange(256) % 40).astype(np.int64)
    assert _positional(tsobol.path_rng_4d) == _positional(jsobol.path_rng_4d)
    got = tsobol.path_rng_4d(accumulation_count=5,
                             pixel_hash=torch.tensor(hashes.astype(np.int64)),
                             dimension=torch.tensor(dims))
    ref = jsobol.path_rng_4d(accumulation_count=jnp.uint32(5),
                             pixel_hash=jnp.asarray(hashes.astype(np.uint32)),
                             dimension=jnp.asarray(dims.astype(np.uint32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", list(jax_scenes.SCENES))
def test_viewer_renders_every_scene(name, tmp_path, capsys):
    out = tmp_path / "frame.png"
    simple_viewer.main(["--scene", name, "--device", "cpu", "--window-size",
                        "16x16", "-n", "1", "-o", str(out)])
    assert out.stat().st_size > 0
    assert f"rendered {name} 16x16" in capsys.readouterr().out


def test_material_scene_loads_the_shader_ball(tmp_path, monkeypatch):
    path = str(tmp_path / "Shaderball.gltf")
    ball = write_shader_ball(path, slices=12, stacks=6)
    monkeypatch.setattr(jax_scenes, "SHADERBALL_PATH", path)
    monkeypatch.setattr(port_scenes, "SHADERBALL_PATH", path)
    jscene, jcam = jax_scenes.create_material_scene()
    scene, cam = port_scenes.create_material_scene(device="cpu")
    want = scene_arrays(jscene)
    for field in ("tri_verts", "tri_normals_oct", "tri_uvs",
                  "tri_tint_roughness", "tri_material"):
        np.testing.assert_array_equal(getattr(scene, field).numpy(),
                                      want[field], err_msg=field)
    for field, value in want["materials"].items():
        np.testing.assert_array_equal(
            getattr(scene.materials, field).numpy(), value, err_msg=field)
    floor = int((want["tri_material"] == 0).sum())
    assert scene.tri_verts.shape[0] == floor + 7 * ball
    # The rubber core takes material 1, each shell its sweep material; the
    # two nodes are spheres of the same slices and stacks.
    assert int((want["tri_material"] == 1).sum()) == 7 * (ball // 2)
    assert sorted(set(want["tri_material"].tolist())) == list(range(9))
    # On a card: the megakernel's BVH branch (kExtras: a textured floor).
    assert tpm.megakernel_ineligibility_reasons(
        scene, tpt.RenderSettings()) == []
    assert tpm.MAX_TRIS < scene.tri_verts.shape[0] <= tpm.HIER_MAX_TRIS
    ref = np.asarray(jpt.render_sample(jscene, jcam, 16, 16, 1,
                                       jpt.RenderSettings()))
    port_cam = camera_from_numpy(camera_arrays(jcam), device="cpu")
    img = tpt.render_sample(scene, port_cam, 16, 16, 1,
                            tpt.RenderSettings()).numpy()
    assert_statistical_gate(img, ref)
