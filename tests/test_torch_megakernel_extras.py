"""The port's environment-lit, textured and cutout scenes against the JAX
package, on the CPU: the plain version of the mesh megakernel's three
further branches, their tables and their eligibility (the wavefront's
frames on these scenes are in tests/test_torch_wavefront_extras.py).

Four scenes are built by the JAX package and carried across with
``render_scene_from_numpy`` (map, CDFs, per-pixel pdf, pool and texture
atlas included), so both packages render the very same arrays: Sphere
(``create_sphere_scene``), sphere_sun (the Sphere scene under the port's
non-uniform map, pool of 1,024), Opacity (``create_opacity_scene``) and the
textured Cornell of ``tests/test_pallas_mesh.py:84-120``. Frames are 32², 2
bounces, under the statistical gate of tests/test_pallas_mesh.py:25-42 (at
most 3% of pixels off by more than 1e-3, means within 2%). The JAX
megakernel runs in Pallas interpret mode, once per scene. The two scenes of
the BVH trace are the port's own; there the plain version is held against
the port's wavefront.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bifrost3d_tpu.apps import scenes as jscenes
from bifrost3d_tpu.integrator import pallas_mesh as jpm
from bifrost3d_tpu.integrator import path_tracer as jpt
from bifrost3d_tpu.io import texture as jtex
from bifrost3d_tpu.lights import environment as jenv

from bifrost3d_tpu_torch.apps import scenes as port_scenes
from bifrost3d_tpu_torch.integrator import pallas_mesh as tpm
from bifrost3d_tpu_torch.integrator import path_tracer as tpt
from bifrost3d_tpu_torch.io import texture as ttex
from bifrost3d_tpu_torch.lights import environment as tenv
from bifrost3d_tpu_torch.scene.camera import camera_from_numpy
from bifrost3d_tpu_torch.scene.render_scene import render_scene_from_numpy
from torch_parity import (
    _to_numpy,
    assert_statistical_gate,
    camera_arrays,
    scene_arrays,
)

RES = 32
BOUNCES = 2
DENSE = ("sphere", "sphere_sun", "opacity", "textured_cornell")


def _jax_sphere_sun():
    from bifrost3d_tpu.geometry import make_plane, make_sphere
    from bifrost3d_tpu.scene.camera import perspective_camera
    from bifrost3d_tpu.scene.materials import MaterialArray, dielectric
    from bifrost3d_tpu.scene.render_scene import build_render_scene
    mats = MaterialArray.build([dielectric((0.5, 0.5, 0.5), 0.8),
                                dielectric((0.8, 0.2, 0.2), 0.3)])
    instances = [(make_plane(size=20.0), 0, jscenes._trs((0, -0.5, 0))),
                 (make_sphere(radius=0.5), 1, jscenes._trs((0, 0, 0)))]
    scene = build_render_scene(
        instances, mats, environment_map=port_scenes.sun_environment_map(),
        presample_environment=1024)
    return scene, perspective_camera(eye=(0, 0.5, -2.5), target=(0, 0, 0),
                                     fov_radians=np.pi / 4, aspect=1.0)


def _jax_textured_cornell():
    """tests/test_pallas_mesh.py:84-120, built by the JAX package."""
    from bifrost3d_tpu.geometry.creation import make_box
    from bifrost3d_tpu.lights.types import LIGHT_SPHERE, LightArray
    from bifrost3d_tpu.scene.camera import perspective_camera
    from bifrost3d_tpu.scene.materials import MaterialArray, dielectric
    from bifrost3d_tpu.scene.render_scene import build_render_scene
    floor_mesh, floor_mat, floor_tex = jscenes._checkered_floor_parts(
        floor_size=4.0, checker_size=0.5)
    textures = jtex.TextureBank.build([floor_tex])
    floor_mat["tint_roughness_texture"] = 0
    mats = MaterialArray.build([floor_mat, dielectric((0.6, 0.3, 0.2), 0.4)])
    instances = [(floor_mesh, 0, jscenes._trs((0, -0.5, 0))),
                 (make_box(size=0.6), 1, jscenes._trs((0, -0.2, 0.3)))]
    lights = LightArray.build([{"kind": LIGHT_SPHERE,
                                "position": (0.0, 1.4, -0.5), "radius": 0.2,
                                "power": (30.0,) * 3}])
    scene = build_render_scene(instances, mats, lights, textures=textures)
    return scene, perspective_camera(eye=(0, 0.6, -2.2), target=(0, -0.2, 0),
                                     fov_radians=np.pi / 4, aspect=1.0)


_JAX_BUILDERS = {"sphere": jscenes.create_sphere_scene,
                 "sphere_sun": _jax_sphere_sun,
                 "opacity": jscenes.create_opacity_scene,
                 "textured_cornell": _jax_textured_cornell}


@pytest.fixture(scope="module")
def jax_scenes():
    """name → (JAX scene, JAX camera, port scene, port camera), the port's
    carried across from the JAX arrays."""
    cache = {}

    def get(name):
        if name not in cache:
            scene, cam = _JAX_BUILDERS[name]()
            cache[name] = (
                scene, cam,
                render_scene_from_numpy(scene_arrays(scene), device="cpu"),
                camera_from_numpy(camera_arrays(cam), device="cpu"))
        return cache[name]
    return get


@pytest.fixture(scope="module")
def jax_frames():
    """name → (JAX render_sample, JAX megakernel in interpret mode, its
    rays), each rendered once."""
    cache = {}

    def get(jax_scenes, name):
        if name not in cache:
            scene, cam, _, _ = jax_scenes(name)
            settings = jpt.settings_for_scene(scene, max_bounce_count=BOUNCES)
            assert jpm.mesh_megakernel_eligible(scene, settings)
            wavefront = np.asarray(jpt.render_sample(
                scene, cam, RES, RES, jnp.uint32(0), settings))
            img, rays = jpm.render_mesh_megakernel(
                scene, cam, RES, RES, jnp.uint32(0), settings, interpret=True)
            cache[name] = (wavefront, np.asarray(img), float(rays))
        return cache[name]
    return get


def _settings(scene):
    return tpt.settings_for_scene(scene, max_bounce_count=BOUNCES)


# -- scenes and settings ---------------------------------------------------------

@pytest.mark.parametrize("name", DENSE)
def test_settings_for_scene_match_jax(jax_scenes, name):
    jscene, _, scene, _ = jax_scenes(name)
    jset = jpt.settings_for_scene(jscene, max_bounce_count=BOUNCES)
    settings = _settings(scene)
    for field in ("coverage_aware_shadows", "passthrough_slack",
                  "shadow_coverage_steps", "use_presampled_environment",
                  "sort_rays_every", "trilinear_textures",
                  "max_bounce_count", "next_event_sample_count"):
        assert getattr(settings, field) == getattr(jset, field), field
    assert settings.coverage_aware_shadows == (name == "opacity")


def _assert_same_scene(scene, ref):
    np.testing.assert_array_equal(scene.tri_material.numpy(),
                                  ref.tri_material.numpy())
    np.testing.assert_allclose(scene.tri_verts.numpy(), ref.tri_verts.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(scene.tri_uvs.numpy(), ref.tri_uvs.numpy(),
                               rtol=1e-6, atol=1e-6)
    for field in ref.materials._fields:
        np.testing.assert_allclose(getattr(scene.materials, field).numpy(),
                                   getattr(ref.materials, field).numpy(),
                                   err_msg=field)
    for a, b in zip(scene.textures, ref.textures):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)
    assert (scene.environment is None) == (ref.environment is None)
    if ref.environment is not None:
        np.testing.assert_array_equal(scene.environment.image.numpy(),
                                      ref.environment.image.numpy())
        # CDF differences (see tests/test_torch_environment.py).
        np.testing.assert_allclose(scene.environment.per_pixel_pdf.numpy(),
                                   ref.environment.per_pixel_pdf.numpy(),
                                   rtol=1e-5, atol=2e-6)
        pool, rpool = scene.environment_presampled, ref.environment_presampled
        assert pool.sample_count == rpool.sample_count
        # A sample's place in its cell is (u − cdf) / pdf: the tables' last
        # bit, divided by a cell's probability.
        np.testing.assert_allclose(pool.directions.numpy(),
                                   rpool.directions.numpy(), atol=2e-5)


@pytest.mark.parametrize("name, build", [
    ("sphere", port_scenes.SCENES["Sphere"]),
    ("opacity", port_scenes.SCENES["Opacity"]),
    ("textured_cornell", port_scenes.TEST_SCENES["textured_cornell"]),
])
def test_own_build_matches_jax_scene(jax_scenes, name, build):
    _, jcam, ref, _ = jax_scenes(name)
    scene, cam = build(device="cpu")
    _assert_same_scene(scene, ref)
    np.testing.assert_allclose(cam.inverse_projection.numpy(),
                               camera_arrays(jcam)["inverse_projection"],
                               rtol=1e-6)


def test_viewer_lists_sphere_and_opacity():
    assert {"Sphere", "Opacity"} <= set(port_scenes.SCENES)
    assert {"textured_cornell", "sphere_sun", "hier_bridge_15k_env",
            "opacity_hier"} <= set(port_scenes.TEST_SCENES)
    env = port_scenes.sun_environment_map()
    assert env.shape == (32, 64, 3) and env.dtype == np.float32
    np.testing.assert_array_equal(env, port_scenes.sun_environment_map())
    # Not uniform, and its patch is off both axes.
    y, x = np.unravel_index(env[..., 0].argmax(), env.shape[:2])
    assert env.max() > 20 * np.median(env)
    assert y not in (0, 15, 16, 31) and x not in (0, 31, 32, 63)


# -- the plain megakernel ---------------------------------------------------------------

def _port_megakernel(scene, cam, settings=None):
    settings = settings or _settings(scene)
    assert tpm.mesh_megakernel_eligible(scene, settings), \
        tpm.megakernel_ineligibility_reasons(scene, settings)
    before = tpm.launch_count
    img, rays = tpm.render_mesh_megakernel(scene, cam, RES, RES, 0, settings)
    assert tpm.launch_count == before   # CPU tensors: the plain version
    assert img.shape == (RES, RES, 3)
    return img.numpy(), float(rays)


@pytest.mark.parametrize("name", DENSE)
def test_plain_megakernel_matches_jax_interpret(jax_scenes, jax_frames, name):
    _, _, scene, cam = jax_scenes(name)
    wavefront, ref, jrays = jax_frames(jax_scenes, name)
    img, rays = _port_megakernel(scene, cam)
    assert_statistical_gate(img, ref)
    assert_statistical_gate(img, wavefront)
    assert abs(rays - jrays) <= 0.02 * jrays, (rays, jrays)
    assert img.mean() > 1e-4
    if name == "textured_cornell":
        # tests/test_pallas_mesh.py:118-120: the checker shows.
        row = img[-4]
        assert row.max() > 2.0 * max(row.min(), 1e-4)


@pytest.mark.parametrize("name", ["hier_bridge_15k_env", "opacity_hier"])
def test_plain_megakernel_bvh_matches_port_wavefront(name):
    scene, cam = port_scenes.TEST_SCENES[name](device="cpu")
    assert int(scene.tri_verts.shape[0]) > tpm.MAX_TRIS
    settings = _settings(scene)
    img, rays = _port_megakernel(scene, cam, settings)
    args = tpm.megakernel_inputs(scene, cam, 8, 8, 0, settings)
    assert args[-1].hier and args[-1].extras
    ref, ref_rays = tpt.render_sample_pooled_counted(scene, cam, RES, RES, 0,
                                                     settings)
    assert_statistical_gate(img, ref.numpy())
    assert abs(rays - int(ref_rays)) <= 0.02 * int(ref_rays)
    assert img.mean() > 1e-3


def test_march_counts_its_traces(jax_scenes):
    _, _, scene, cam = jax_scenes("opacity")
    args = tpm.megakernel_inputs(scene, cam, 16, 16, 0, _settings(scene))
    stats = {}
    r, g, b, rays = tpm.mesh_megakernel_reference(*args, stats=stats)
    assert args[-1].shadow_steps == 4
    # Fewer traces than four per shadow ray: a lane stops at its first miss.
    assert 0 < stats["march_traces"] < 4 * float(rays.sum()) / 2
    assert "shadow_traces" not in stats


@pytest.mark.parametrize("name", ["sphere", "opacity"])
def test_binary_shadow_rays_are_counted(jax_scenes, name):
    """Without the march the plain version counts one any-hit query per lit
    shaded hit: fewer than one per iteration, since an iteration that ends
    in a miss or a passthrough traces none."""
    _, _, scene, cam = jax_scenes(name)
    settings = tpt.RenderSettings(max_bounce_count=BOUNCES)
    args = tpm.megakernel_inputs(scene, cam, 16, 16, 0, settings)
    assert args[-1].shadow_steps == 0
    stats = {}
    r, g, b, rays = tpm.mesh_megakernel_reference(*args, stats=stats)
    iterations = float(rays.sum()) / 2
    assert 0 < stats["shadow_traces"] < iterations
    assert "march_traces" not in stats
    # Counting changes nothing.
    again = tpm.mesh_megakernel_reference(*args)
    assert all(torch.equal(a, b) for a, b in zip((r, g, b, rays), again))


# -- tables ----------------------------------------------------------------------------

def _unpack2d(table, n, n_attrs):
    """The JAX kernel's (A·R, 128) packing → [n, A]."""
    table = np.asarray(table)
    r = max(1, (n + 127) // 128)
    return np.stack([table[a * r:(a + 1) * r].reshape(-1)[:n]
                     for a in range(n_attrs)], axis=1)


@pytest.mark.parametrize("name", ["sphere", "sphere_sun"])
def test_packed_environment_matches_jax(jax_scenes, name):
    jscene, _, scene, _ = jax_scenes(name)
    jimg, jpdf, jpool, jmeta = jpm._pack_env(jscene)
    img, pdf, pool, meta = tpm._pack_env(scene)
    assert meta == tuple(jmeta[:6])
    w, h, pw, ph, n_pool, nee = meta
    assert nee and n_pool == scene.environment_presampled.sample_count
    np.testing.assert_array_equal(img.numpy(), _unpack2d(jimg, h * w, 3))
    np.testing.assert_array_equal(pdf.numpy(),
                                  _unpack2d(jpdf, ph * pw, 1)[:, 0])
    np.testing.assert_array_equal(pool.numpy(), _unpack2d(jpool, n_pool, 7))
    assert tpm._pack_env(scene)[0] is img            # cached per identity
    args = tpm.megakernel_inputs(scene, scene_camera(jax_scenes, name), 8, 8,
                                 0, _settings(scene))
    # The tint slot carries the environment's own tint.
    np.testing.assert_array_equal(args[11][1:4].numpy(),
                                  scene.environment.tint.numpy())
    assert args[-1].n_nee_total == scene.lights.count + 1


def scene_camera(jax_scenes, name):
    return jax_scenes(name)[3]


@pytest.mark.parametrize("name", ["opacity", "textured_cornell"])
def test_packed_textures_match_jax(jax_scenes, name):
    jscene, _, scene, _ = jax_scenes(name)
    jtab, jmeta = jpm._pack_textures(jscene)
    texels, meta = tpm._pack_textures(scene)
    assert len(meta) == len(jmeta) == scene.textures.count
    for (base, w, h, wu, wv, filt), jm in zip(meta, jmeta):
        jbase_row, jw, jh, jwu, jwv, jfilt, r = jm
        assert (w, h, wu, wv, filt) == (jw, jh, jwu, jwv, jfilt)
        block = np.asarray(jtab)[jbase_row:jbase_row + 4 * r]
        np.testing.assert_array_equal(texels[base:base + h * w].numpy(),
                                      _unpack2d(block, h * w, 4))
    assert tpm._pack_textures(scene)[0] is texels
    info, jinfo = tpm._static_info(scene), jpm._static_info(jscene)
    assert info["mat_tex"] == jinfo["mat_tex"]
    assert info["light_kinds"] == jinfo["light_kinds"]


def test_kernel_config_of_the_new_scenes(jax_scenes):
    """Which instantiation a frame takes: the extras one only where the
    scene needs it."""
    expected = {"sphere": (True, False, 0), "sphere_sun": (True, False, 0),
                "opacity": (False, True, 4),
                "textured_cornell": (False, False, 0)}
    for name, (has_env, coverage, steps) in expected.items():
        _, _, scene, cam = jax_scenes(name)
        cfg = tpm.megakernel_inputs(scene, cam, 8, 8, 0, _settings(scene))[-1]
        assert cfg.extras and not cfg.hier
        assert (cfg.env_meta is not None) == has_env
        assert cfg.any_coverage == coverage and cfg.shadow_steps == steps
    scene, cam = port_scenes.create_cornell_box(device="cpu")
    args = tpm.megakernel_inputs(scene, cam, 8, 8, 0, _settings(scene))
    assert not args[-1].extras and args[-2] is None
    # Coverage-aware shadows asked for on an opaque scene: the march runs.
    forced = tpt.settings_for_scene(scene, coverage_aware_shadows=True)
    cfg = tpm.megakernel_inputs(scene, cam, 8, 8, 0, forced)[-1]
    assert cfg.extras and cfg.shadow_steps == 4 and cfg.any_coverage


def test_prewarm_packs_the_new_tables(jax_scenes):
    _, _, scene, _ = jax_scenes("opacity")
    _, _, sphere, _ = jax_scenes("sphere_sun")
    tpm._TEX_CACHE.clear()
    tpm._ENV_CACHE.clear()
    tpm.prewarm_megakernel(scene)
    tpm.prewarm_megakernel(sphere)
    assert len(tpm._TEX_CACHE) == 1 and len(tpm._ENV_CACHE) == 1


# -- eligibility -------------------------------------------------------------------------

def _both(jscene, scene, jsettings=None, settings=None):
    jreasons = jpm.megakernel_ineligibility_reasons(
        jscene, jsettings or jpt.settings_for_scene(jscene))
    reasons = tpm.megakernel_ineligibility_reasons(
        scene, settings or tpt.settings_for_scene(scene))
    return jreasons, reasons


@pytest.mark.parametrize("name", DENSE)
def test_new_scenes_are_eligible(jax_scenes, name):
    jscene, _, scene, _ = jax_scenes(name)
    assert _both(jscene, scene) == ([], [])
    assert tpt.explain_render_path(scene, _settings(scene)) == \
        "wavefront: device is cpu, not cuda"


@pytest.mark.parametrize("case", [
    "large_map", "large_pdf", "no_pool", "large_pool", "cdf_search",
    "bilinear_texture", "metallic_texture", "no_bank", "many_texels"])
def test_ineligibility_reasons_equal_jax(jax_scenes, case):
    """Out-of-scope cases give the JAX package's reasons, string for
    string."""
    jsettings = settings = None
    if case in ("large_map", "large_pdf", "no_pool", "large_pool",
                "cdf_search"):
        jscene, _, scene, _ = jax_scenes("sphere_sun")
        if case in ("large_map", "large_pdf"):
            shape = (40, 120) if case == "large_map" else (140, 64)
            img = np.random.default_rng(50).uniform(
                0.1, 1.0, size=shape + (3,)).astype(np.float32)
            jlight = jenv.build_environment_light(img)
            light = tenv.EnvironmentLight.from_numpy(_to_numpy(jlight),
                                                     device="cpu")
            jscene = jscene._replace(environment=jlight)
            scene = scene._replace(environment=light)
            expect = (f"environment map 40x120 > MAX_ENV_TEXELS 4096"
                      if case == "large_map" else
                      "environment pdf grid 140x64 > MAX_ENV_PDF 8192")
        elif case == "no_pool":
            jscene = jscene._replace(environment_presampled=None)
            scene = scene._replace(environment_presampled=None)
            expect = ("environment without presampled pool "
                      "(build_render_scene presample_environment)")
        elif case == "large_pool":
            jpool, pool = jscene.environment_presampled, \
                scene.environment_presampled
            jscene = jscene._replace(environment_presampled=jpool._replace(
                directions=jnp.tile(jpool.directions, (16, 1)),
                radiances=jnp.tile(jpool.radiances, (16, 1)),
                pdfs=jnp.tile(jpool.pdfs, 16)))
            scene = scene._replace(environment_presampled=pool._replace(
                directions=pool.directions.repeat(16, 1),
                radiances=pool.radiances.repeat(16, 1),
                pdfs=pool.pdfs.repeat(16)))
            expect = "environment pool 16384 > MAX_ENV_POOL 8192"
        else:
            jsettings = jpt.settings_for_scene(
                jscene, use_presampled_environment=False)
            settings = tpt.settings_for_scene(
                scene, use_presampled_environment=False)
            expect = ("CDF-search environment NEE "
                      "(use_presampled_environment=False)")
    else:
        jscene, _, scene, _ = jax_scenes("textured_cornell")
        jmats, mats = jscene.materials, scene.materials
        if case == "bilinear_texture":
            jscene = jscene._replace(textures=jscene.textures._replace(
                filters=jnp.asarray([jtex.FILTER_LINEAR], jnp.int32)))
            scene = scene._replace(textures=scene.textures._replace(
                filters=torch.tensor([ttex.FILTER_LINEAR], dtype=torch.int32)))
            expect = "non-nearest texture filtering"
        elif case == "metallic_texture":
            jscene = jscene._replace(materials=jmats._replace(
                metallic_texture=jmats.metallic_texture.at[1].set(0)))
            slot = mats.metallic_texture.clone()
            slot[1] = 0
            scene = scene._replace(materials=mats._replace(
                metallic_texture=slot))
            expect = "metallic textures"
        elif case == "no_bank":
            jscene = jscene._replace(textures=jtex.TextureBank.build([]))
            scene = scene._replace(
                textures=ttex.TextureBank.build([], device="cpu"))
            expect = "texture bindings without a texture bank"
        else:
            big = [{"image": np.ones((80, 80, 4), np.float32),
                    "filter": ttex.FILTER_NONE}]
            jscene = jscene._replace(textures=jtex.TextureBank.build(big))
            scene = scene._replace(
                textures=ttex.TextureBank.build(big, device="cpu"))
            expect = "6400 texels > MAX_TEX_TEXELS 4096"
    jreasons, reasons = _both(jscene, scene, jsettings, settings)
    assert reasons == jreasons
    assert expect in reasons, reasons
    assert tpt.explain_render_path(scene, settings or _settings(scene)) == (
        "wavefront: device is cpu, not cuda, " + ", ".join(reasons))


def test_no_reason_says_not_ported(jax_scenes):
    for name in DENSE:
        _, _, scene, _ = jax_scenes(name)
        bad = scene._replace(environment_presampled=None)
        for settings in (tpt.RenderSettings(), tpt.RenderSettings(
                coverage_aware_shadows=True, path_regularization_scale=1.0,
                use_presampled_environment=False)):
            for reason in tpm.megakernel_ineligibility_reasons(bad, settings):
                assert "not ported" not in reason
    for limit in ("MAX_TEX_TEXELS", "MAX_ENV_TEXELS", "MAX_ENV_PDF",
                  "MAX_ENV_POOL"):
        assert getattr(tpm, limit) == getattr(jpm, limit)


# -- the viewer -------------------------------------------------------------------------

@pytest.mark.parametrize("scene", ["Sphere", "Opacity"])
def test_viewer_renders_the_new_scenes(tmp_path, scene, capsys):
    from bifrost3d_tpu_torch.apps import simple_viewer
    out = tmp_path / f"{scene}.png"
    simple_viewer.main(["--scene", scene, "--device", "cpu", "--window-size",
                        "24x16", "-n", "2", "--max-bounces", "2", "-o",
                        str(out), "--environment-tint", "0.1,0.2,0.3"])
    assert f"rendered {scene} 24x16 n=2 on cpu" in capsys.readouterr().out
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 200
    # The same frames, straight from the library with the reference
    # viewer's settings (a plain RenderSettings): lit, and the same PNG.
    from bifrost3d_tpu_torch.io.image import save_image
    from bifrost3d_tpu_torch.post.pipeline import process
    from bifrost3d_tpu_torch.post.tonemap import CameraEffectsSettings
    built, cam = port_scenes.SCENES[scene](aspect=24 / 16, device="cpu")
    built = built._replace(environment_tint=torch.tensor([0.1, 0.2, 0.3]))
    hdr = tpt.render_progressive(built, cam, 24, 16, 2,
                                 tpt.RenderSettings(max_bounce_count=2))
    assert bool(torch.isfinite(hdr).all()) and float(hdr.mean()) > 1e-4
    again = tmp_path / "library.png"
    save_image(str(again), process(hdr, CameraEffectsSettings.preset(
        )._replace(tonemapping_mode=1, film_grain=0.0)))
    assert again.read_bytes() == data


def test_viewer_settings_frame_matches_jax(jax_scenes):
    """The viewer's settings on Opacity (no coverage-aware shadows, as the
    reference viewer's plain RenderSettings): binary shadow rays, the JAX
    frame."""
    jscene, jcam, scene, cam = jax_scenes("opacity")
    jset = jpt.RenderSettings(max_bounce_count=BOUNCES)
    settings = tpt.RenderSettings(max_bounce_count=BOUNCES)
    assert not settings.coverage_aware_shadows
    assert settings.passthrough_slack == jset.passthrough_slack == 2
    ref = np.asarray(jpt.render_sample(jscene, jcam, RES, RES, jnp.uint32(0),
                                       jset))
    img = tpt.render_sample(scene, cam, RES, RES, 0, settings)
    assert_statistical_gate(img.numpy(), ref)
    assert tpm.megakernel_ineligibility_reasons(scene, settings) == []
    marched = tpt.render_sample(scene, cam, RES, RES, 0, _settings(scene))
    assert float((marched - img).abs().max()) > 1e-3


@pytest.mark.parametrize("argv, message", [
    (["--scene", "Sphere", "--environment-map", "sky.exr"], "Sphere"),
    (["--scene", "Glass"], "Glass"),
    (["--scene", "MaterialScene"], "MaterialScene"),
])
def test_viewer_names_what_is_not_ported(argv, message, tmp_path, capsys):
    """Each renders (16 × 16, one accumulation) and the viewer's line names
    it: ``--environment-map``, which raised for the missing image reader
    until the EXR reader was ported (here a map written by the port's
    save_exr), and Glass and MaterialScene, which raised before they were
    ported."""
    from bifrost3d_tpu_torch.apps import simple_viewer
    from bifrost3d_tpu_torch.io.image import save_exr
    if "--environment-map" in argv:
        sky = tmp_path / "sky.exr"
        save_exr(str(sky), np.full((8, 16, 3), 0.5, np.float32))
        argv = argv[:-1] + [str(sky)]
    out = tmp_path / "frame.png"
    simple_viewer.main(argv + ["--device", "cpu", "--window-size", "16x16",
                               "-n", "1", "-o", str(out)])
    assert out.stat().st_size > 0
    assert f"rendered {message} " in capsys.readouterr().out
