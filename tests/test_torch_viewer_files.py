"""The viewer on the user's own files, against the JAX package.

A small OBJ + MTL (a sphere on a plane, two materials, ``vn`` and ``vt``)
and a small textured ``.glb`` (a torus, a MASK material with RGBA base
and metallic-roughness PNGs): ``build_scene_from_file`` gives JAX's scene
(soup, normals, uvs, materials, texture bank, camera at aspect 1.0), one
16² frame of each passes the statistical gate against JAX's, and
``render_aovs`` gives JAX's AOVs. The viewer's ``main`` on the CPU with an
EXR ``--environment-map``, every ``--aov`` and ``-o x.exr``; and the
reference's behaviours that the port mirrors: a built-in scene keeps its
presampled pool under ``--environment-map``, a file's camera has aspect
1.0 whatever the window.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifrost3d_tpu.apps import scenes as jscenes
from bifrost3d_tpu.apps import simple_viewer as jviewer
from bifrost3d_tpu.integrator import aov as jaov
from bifrost3d_tpu.integrator import path_tracer as jpt
from bifrost3d_tpu.io import image as jimage
from bifrost3d_tpu.lights.environment import (
    build_environment_light as jax_environment,
)

from bifrost3d_tpu_torch.apps import simple_viewer
from bifrost3d_tpu_torch.geometry.creation import (
    make_plane,
    make_sphere,
    make_torus,
)
from bifrost3d_tpu_torch.geometry.mesh import combine_meshes, transform_mesh
from bifrost3d_tpu_torch.integrator import aov as taov
from bifrost3d_tpu_torch.integrator import path_tracer as tpt
from bifrost3d_tpu_torch.io import image as timage
from bifrost3d_tpu_torch.scene.render_scene import render_scene_from_numpy
from test_torch_megakernel_extras import _assert_same_scene
from torch_parity import (
    assert_close_f32,
    assert_statistical_gate,
    camera_arrays,
    scene_arrays,
)
from torch_scene_files import write_obj, write_textured_glb

RES = 16
TINT = (0.68, 0.92, 1.0)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{"obj": path, "glb": path, "sky": an EXR map}."""
    d = tmp_path_factory.mktemp("files")
    sphere = transform_mesh(make_sphere(radius=0.5, slices=16, stacks=8),
                            np.asarray([[1, 0, 0, 0], [0, 1, 0, 0.5],
                                        [0, 0, 1, 0]], np.float32))
    parts = [sphere, make_plane(size=3.0)]
    mesh = combine_meshes(parts)
    tri_material = np.repeat([0, 1], [p.indices.shape[0] for p in parts])
    idx = mesh.indices
    write_obj(str(d / "scene.obj"), mesh.positions[idx], tri_material,
              [dict(name="gold", Kd=(1.0, 0.766, 0.336), Ns=90, illum=3,
                    d=1.0),
               dict(name="floor", Kd=(0.6, 0.6, 0.55), Ns=4, illum=2)],
              tri_normals=mesh.normals[idx], tri_uvs=mesh.texcoords[idx])
    rng = np.random.default_rng(0)
    write_textured_glb(str(d / "torus.glb"),
                       make_torus(major_segments=24, minor_segments=12),
                       rng.integers(0, 256, (32, 32, 4)),
                       rng.integers(0, 256, (32, 32, 3)))
    sky = np.concatenate([np.full((8, 32, 3), 2.0), np.full((8, 32, 3), 0.2)])
    sky[2, 5] = 400.0
    timage.save_exr(str(d / "sky.exr"), sky.astype(np.float32))
    return {"obj": str(d / "scene.obj"), "glb": str(d / "torus.glb"),
            "sky": str(d / "sky.exr")}


@pytest.fixture(scope="module")
def scenes(files):
    """{kind: (JAX scene, JAX camera, port scene, port camera)}."""
    out = {}
    for kind in ("obj", "glb"):
        js, jc = jviewer.build_scene_from_file(files[kind], None, TINT)
        ps, pc = simple_viewer.build_scene_from_file(files[kind], None, TINT,
                                                     device="cpu")
        out[kind] = (js, jc, ps, pc)
    return out


@pytest.mark.parametrize("kind", ["obj", "glb"])
def test_build_scene_from_file_matches_jax(kind, scenes):
    js, jc, ps, pc = scenes[kind]
    ref = scene_arrays(js)
    _assert_same_scene(ps, render_scene_from_numpy(ref, device="cpu"))
    assert abs(ps.tri_normals_oct.numpy().astype(int)
               - ref["tri_normals_oct"].astype(int)).max() <= 1
    np.testing.assert_array_equal(ps.environment_tint.numpy(),
                                  np.asarray(TINT, np.float32))
    assert ps.textures.count == (3 if kind == "glb" else 0)
    jcam = camera_arrays(jc)
    for got, name in ((pc.transform.translation, "translation"),
                      (pc.transform.rotation, "rotation"),
                      (pc.inverse_projection, "inverse_projection")):
        np.testing.assert_allclose(got.numpy(), jcam[name], rtol=1e-6,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("kind", ["obj", "glb"])
def test_file_frame_matches_jax(kind, scenes):
    js, jc, ps, pc = scenes[kind]
    ref = np.asarray(jpt.render_sample(js, jc, RES, RES, jnp.uint32(0),
                                       jpt.RenderSettings(max_bounce_count=4)))
    img = tpt.render_sample(ps, pc, RES, RES, 0,
                            tpt.RenderSettings(max_bounce_count=4))
    assert_statistical_gate(img.numpy(), ref)


@pytest.mark.parametrize("kind", ["obj", "glb"])
def test_render_aovs_matches_jax(kind, scenes):
    """Every AOV against JAX's. The traces (JAX's Pallas kernel in
    interpret mode, the port's plain dense trace) run in float32 only, so
    the gate is assert_close_f32, on the pixels where both hit the same
    triangle (every pixel here)."""
    js, jc, ps, pc = scenes[kind]
    ref = {k: np.asarray(v) for k, v in jaov.render_aovs(js, jc, RES,
                                                         RES).items()}
    got = {k: v.numpy() for k, v in taov.render_aovs(ps, pc, RES, RES).items()}
    assert got.keys() == ref.keys()
    # The same 10-bit codes (JAX's jitted ``/ 1023.0`` may be a multiply
    # by the reciprocal, an ulp off the division).
    np.testing.assert_array_equal(np.round(got["primitive_id"] * 1023),
                                  np.round(ref["primitive_id"] * 1023))
    np.testing.assert_array_max_ulp(got["primitive_id"], ref["primitive_id"],
                                    maxulp=1)
    hit = ref["depth"] < 1.0
    assert 0.1 < hit.mean() < 1.0
    for name in ("tint", "roughness"):
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    for name in ("depth", "albedo", "shading_normal"):
        assert got[name].dtype == np.float32 and got[name].shape == \
            ref[name].shape
        assert_close_f32(got[name], ref[name], atol=1e-5)


@pytest.mark.parametrize("aov", simple_viewer.AOVS)
def test_viewer_writes_each_aov(aov, files, scenes, tmp_path, capsys):
    """``--aov`` on the glTF, as PNG and EXR: the EXR holds the AOV image
    (scalars in three channels, the normal mapped to [0, 1]), the PNG its
    unencoded bytes."""
    _, _, ps, pc = scenes["glb"]
    want = simple_viewer.aov_image(taov.render_aovs(ps, pc, RES, RES), aov)
    for ext in ("exr", "png"):
        out = str(tmp_path / f"{aov}.{ext}")
        simple_viewer.main(["--scene", files["glb"], "--aov", aov, "--device",
                            "cpu", "--window-size", f"{RES}x{RES}", "-o",
                            out])
        if ext == "exr":
            np.testing.assert_array_equal(timage.load_exr(out), want)
        else:
            np.testing.assert_array_equal(
                timage.read_png(out), (want * 255 + 0.5).astype(np.uint8))
    assert f"rendered {files['glb']} {RES}x{RES}" in capsys.readouterr().out


@pytest.mark.parametrize("kind", ["obj", "glb", "CornellBox"])
def test_viewer_renders_with_environment_map(kind, files, tmp_path):
    out = str(tmp_path / "frame.exr")
    scene = files.get(kind, kind)
    simple_viewer.main(["--scene", scene, "--environment-map", files["sky"],
                        "--device", "cpu", "--window-size", f"{RES}x{RES}",
                        "-n", "2", "-o", out])
    img = timage.load_exr(out)
    assert img.shape == (RES, RES, 3) and np.isfinite(img).all()
    assert img.mean() > 0.01


def test_environment_map_keeps_a_scene_pool(files):
    """On a built-in scene ``--environment-map`` replaces ``environment``
    and keeps ``environment_presampled`` (JAX's simple_viewer.py:121):
    Sphere's NEE still draws its constant map's pool."""
    env = timage.load_image(files["sky"])
    np.testing.assert_array_equal(env, jimage.load_image(files["sky"]))
    scene, _ = simple_viewer.viewer_scene("Sphere", env, TINT, RES, RES,
                                          device="cpu")
    jscene, _ = jscenes.SCENES["Sphere"](aspect=1.0)
    jscene = jscene._replace(environment=jax_environment(env))
    np.testing.assert_array_equal(scene.environment.image.numpy(), env)
    np.testing.assert_array_equal(np.asarray(jscene.environment.image), env)
    pool = scene.environment_presampled
    np.testing.assert_allclose(
        pool.radiances.numpy(),
        np.asarray(jscene.environment_presampled.radiances), rtol=1e-6)
    # The pool is the built-in map's (a constant 0.8), not the new map's.
    np.testing.assert_allclose(pool.radiances.numpy(), 0.8, rtol=1e-6)
    img = tpt.render_sample(scene, *simple_viewer.viewer_scene(
        "Sphere", env, TINT, RES, RES, device="cpu")[1:], RES, RES, 0,
        tpt.RenderSettings(max_bounce_count=2))
    assert torch.isfinite(img).all()


def test_file_camera_has_aspect_one(files):
    """``build_scene_from_file``'s camera is at aspect 1.0 whatever the
    window (JAX's simple_viewer.py:53-54)."""
    _, wide = simple_viewer.viewer_scene(files["obj"], None, TINT, 64, 16,
                                         device="cpu")
    _, square = simple_viewer.viewer_scene(files["obj"], None, TINT, 16, 16,
                                           device="cpu")
    _, jc = jviewer.build_scene_from_file(files["obj"], None, TINT)
    np.testing.assert_array_equal(wide.inverse_projection.numpy(),
                                  square.inverse_projection.numpy())
    np.testing.assert_allclose(wide.inverse_projection.numpy(),
                               camera_arrays(jc)["inverse_projection"],
                               rtol=1e-6)


@pytest.mark.parametrize("argv, what", [
    (["--renderer", "preview"], "preview"),
    (["--renderer", "denoised"], "denoised"),
    (["--path-regularization", "0.5"], "path regularization"),
    (["--checkpoint-dir", "ckpt"], "checkpoints"),
])
def test_unported_flags_raise(argv, what, tmp_path, capsys):
    """The four flags are ported (they raised before): each renders a
    finite 8² PNG on the CPU, and says which renderer it took."""
    out = tmp_path / "out.png"
    argv = [a if a != "ckpt" else str(tmp_path / "ckpt") for a in argv]
    simple_viewer.main(["--device", "cpu", "--window-size", "8x8", "-n",
                        "2", "-o", str(out)] + argv)
    img = timage.load_image(str(out))
    assert img.shape[:2] == (8, 8) and np.isfinite(img).all()
    said = capsys.readouterr().out
    if what in ("preview", "denoised"):
        assert f"{what} 8x8" in said, said
    if what == "checkpoints":
        assert sorted(os.listdir(tmp_path / "ckpt")) == ["ckpt_2.npz"]


def test_obj_texture_path_raises_in_the_viewer(files, tmp_path):
    """An MTL ``map_Kd`` makes the material table raise, in JAX's viewer
    as in the port's."""
    obj = tmp_path / "tex.obj"
    obj.write_text("mtllib tex.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
                   "usemtl wood\nf 1 2 3\n")
    (tmp_path / "tex.mtl").write_text("newmtl wood\nKd 1 1 1\n"
                                      "map_Kd wood.png\n")
    with pytest.raises(ValueError, match="could not convert string"):
        jviewer.build_scene_from_file(str(obj), None, TINT)
    with pytest.raises(ValueError, match="could not convert string"):
        simple_viewer.build_scene_from_file(str(obj), None, TINT,
                                            device="cpu")
