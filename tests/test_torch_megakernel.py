"""The port's mesh megakernel slice against the JAX package, on the CPU.

On CPU tensors ``render_mesh_megakernel`` runs the kernel's plain PyTorch
version, ``mesh_megakernel_reference``. It is held against the JAX
megakernel in Pallas interpret mode (at most three runs: each costs about
20 s here) and against JAX ``render_sample`` on the very same scene arrays
(the JAX scene carried across with ``render_scene_from_numpy``), at 32²
and 2 bounces, under the statistical gate of
tests/test_pallas_mesh.py:25-42: float reassociation can flip individual
stochastic decisions, while the RNG chains are bit-exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bifrost3d_tpu.apps.scenes import _trs
from bifrost3d_tpu.apps.scenes import create_cornell_box as jax_cornell_box
from bifrost3d_tpu.apps.scenes import (
    create_sphere_light_scene as jax_sphere_light_scene)
from bifrost3d_tpu.apps.scenes import create_veach_scene as jax_veach_scene
from bifrost3d_tpu.integrator import pallas_mesh as jpm
from bifrost3d_tpu.integrator import path_tracer as jpt

from bifrost3d_tpu_torch.apps import scenes as port_scenes
from bifrost3d_tpu_torch.integrator import pallas_mesh as tpm
from bifrost3d_tpu_torch.integrator import path_tracer as tpt
from bifrost3d_tpu_torch.scene.camera import camera_from_numpy
from bifrost3d_tpu_torch.scene.render_scene import render_scene_from_numpy
from torch_parity import assert_statistical_gate, camera_arrays, scene_arrays

RES = 32
BOUNCES = 2


def _jax_test_scene(name):
    """The scenes of tests/test_pallas_mesh.py:141-241 (and an emissive
    one and a directional-light one), built by the JAX package."""
    from bifrost3d_tpu.geometry.creation import (make_box, make_plane,
                                                 make_sphere)
    from bifrost3d_tpu.lights.types import (LIGHT_DIRECTIONAL, LIGHT_SPHERE,
                                            LIGHT_SPOT, LightArray)
    from bifrost3d_tpu.scene.camera import perspective_camera
    from bifrost3d_tpu.scene.materials import MaterialArray, dielectric, metal
    from bifrost3d_tpu.scene.render_scene import build_render_scene

    if name == "coated":
        mats = [dielectric((0.6, 0.6, 0.6), 0.9),
                dielectric((0.2, 0.4, 0.8), 0.1, coat=1.0, coat_roughness=0.0),
                metal((0.95, 0.64, 0.54), 0.5, coat=0.7, coat_roughness=0.3)]
        instances = [(make_plane(size=8.0), 0, _trs((0, -0.5, 0))),
                     (make_box(size=0.7), 1, _trs((-0.6, -0.15, 0.3))),
                     (make_sphere(radius=0.4, slices=12, stacks=8), 2,
                      _trs((0.7, -0.1, 0.0)))]
        lights = [{"kind": LIGHT_SPHERE, "position": (1.5, 3.0, -2.0),
                   "radius": 0.4, "power": (120.0,) * 3}]
    elif name == "spot":
        down = np.asarray([0.2, -1.0, 0.3], np.float32)
        down /= np.linalg.norm(down)
        mats = [dielectric((0.7, 0.7, 0.7), 0.8),
                dielectric((0.7, 0.2, 0.2), 0.3)]
        instances = [(make_plane(size=10.0), 0, _trs((0, -0.5, 0))),
                     (make_box(size=0.6), 1, _trs((0, -0.2, 0.2)))]
        lights = [{"kind": LIGHT_SPOT, "position": (0.5, 2.5, -0.5),
                   "radius": 0.3, "direction": tuple(down),
                   "cos_angle": 0.8, "power": (120.0,) * 3}]
    elif name == "diffuse":
        mats = [dielectric((0.7, 0.7, 0.7), 0.8),
                dict(tint=(0.2, 0.6, 0.3), roughness=0.6, shading_model=1)]
        instances = [(make_plane(size=10.0), 0, _trs((0, -0.5, 0))),
                     (make_box(size=0.6), 1, _trs((0, -0.2, 0.2)))]
        lights = [{"kind": LIGHT_SPHERE, "position": (1.0, 3.0, -1.5),
                   "radius": 0.4, "power": (100.0,) * 3}]
    elif name == "directional":
        ldir = -np.asarray([1.0, 2.0, -1.0], np.float32)
        ldir /= np.linalg.norm(ldir)
        mats = [dielectric((0.7, 0.7, 0.7), 0.8),
                dielectric((0.7, 0.5, 0.2), 0.3),
                metal((0.9, 0.9, 0.9), 0.15)]
        instances = [(make_plane(size=10.0), 0, _trs((0, -0.5, 0))),
                     (make_box(size=0.6), 1, _trs((-0.4, -0.2, 0.2))),
                     (make_sphere(radius=0.3, slices=12, stacks=8), 2,
                      _trs((0.5, -0.2, 0.0)))]
        lights = [{"kind": LIGHT_SPHERE, "position": (1.0, 2.0, -1.5),
                   "radius": 0.2, "power": (40.0,) * 3},
                  {"kind": LIGHT_DIRECTIONAL, "direction": tuple(ldir),
                   "radiance": (3.0, 2.9, 2.5)}]
    else:
        assert name == "emissive"
        mats = [dielectric((0.7, 0.7, 0.7), 0.8),
                dielectric((0.3, 0.5, 0.7), 0.4),
                dict(tint=(0.1, 0.1, 0.1), roughness=1.0,
                     emission=(4.0, 3.5, 3.0))]
        instances = [(make_plane(size=10.0), 0, _trs((0, -0.5, 0))),
                     (make_box(size=0.6), 1, _trs((0, -0.2, 0.2))),
                     (make_plane(size=0.8), 2,
                      _trs((0, 1.0, 0.2), (0, 0, 1), np.pi))]
        lights = [{"kind": LIGHT_SPHERE, "position": (1.0, 2.0, -1.5),
                   "radius": 0.1, "power": (20.0,) * 3}]
    scene = build_render_scene(instances, MaterialArray.build(mats),
                               LightArray.build(lights))
    cam = perspective_camera(eye=(0, 0.8, -2.6), target=(0, -0.1, 0),
                             fov_radians=np.pi / 4, aspect=1.0)
    return scene, cam


_JAX_BUILDERS = {
    "cornell": jax_cornell_box,
    "veach": jax_veach_scene,
    "veach_mesh_light": lambda: jax_veach_scene(with_mesh_light=True),
    "sphere_light": jax_sphere_light_scene,
    **{name: (lambda n=name: _jax_test_scene(n))
       for name in ("coated", "spot", "diffuse", "emissive",
                    "directional")},
}


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
def jax_interpret():
    """(name, accumulation) → (image, rays) of the JAX megakernel in
    interpret mode, each rendered once."""
    cache = {}

    def get(jax_scenes, name, accumulation):
        if (name, accumulation) not in cache:
            scene, cam, _, _ = jax_scenes(name)
            settings = jpt.settings_for_scene(scene, max_bounce_count=BOUNCES)
            img, rays = jpm.render_mesh_megakernel(
                scene, cam, RES, RES, jnp.uint32(accumulation), settings,
                interpret=True)
            cache[name, accumulation] = (np.asarray(img), float(rays))
        return cache[name, accumulation]
    return get


def _port_megakernel(scene, cam, accumulation):
    settings = tpt.settings_for_scene(scene, max_bounce_count=BOUNCES)
    assert tpm.mesh_megakernel_eligible(scene, settings), \
        tpm.megakernel_ineligibility_reasons(scene, settings)
    before = tpm.launch_count
    img, rays = tpm.render_mesh_megakernel(scene, cam, RES, RES, accumulation,
                                           settings)
    assert tpm.launch_count == before   # CPU tensors: the plain version
    assert img.shape == (RES, RES, 3)
    return img.numpy(), float(rays)


# -- tables ------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cornell", "veach", "coated"])
def test_packed_tables_match_jax(jax_scenes, name):
    jscene, _, scene, _ = jax_scenes(name)
    jpacked = jpm._pack_scene(jscene)
    packed = tpm._pack_scene(scene)
    assert packed["n_tris"] == jpacked["n_tris"]
    np.testing.assert_allclose(packed["tri"].numpy(),
                               np.asarray(jpacked["tri"]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(packed["attr"].numpy(),
                               np.asarray(jpacked["attr"]), rtol=1e-6,
                               atol=1e-6)
    assert tpm._pack_scene(scene) is packed          # cached per identity
    jmats, jm, jlights = jpm._live_tables(jscene)
    mats, m, lights = tpm._live_tables(scene)
    assert m == jm
    np.testing.assert_allclose(mats.numpy(), np.asarray(jmats), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(lights.numpy(), np.asarray(jlights),
                               rtol=1e-6, atol=1e-6)
    info = tpm._static_info(scene)
    jinfo = jpm._static_info(jscene)
    assert info["light_kinds"] == jinfo["light_kinds"]
    assert info["has_coat"] == jinfo["has_coat"]


def test_prewarm_fills_the_caches(jax_scenes):
    _, _, scene, _ = jax_scenes("spot")
    tpm._PACK_CACHE.clear()
    tpm._STATIC_CACHE.clear()
    tpm.prewarm_megakernel(scene)          # on the CPU: no kernel build
    assert len(tpm._PACK_CACHE) == 1 and len(tpm._STATIC_CACHE) == 1
    (packed,) = tpm._PACK_CACHE.values()
    assert tpm._pack_scene(scene) is packed
    assert tpm._static_info(scene)["light_kinds"] == (1,)   # LIGHT_SPOT


# -- eligibility ---------------------------------------------------------------

def _transmissive(scene):
    models = scene.materials.shading_model
    if isinstance(models, torch.Tensor):
        models = models.clone()
        models[0] = 2
        return scene._replace(
            materials=scene.materials._replace(shading_model=models))
    return scene._replace(materials=scene.materials._replace(
        shading_model=models.at[0].set(2)))


@pytest.mark.parametrize("case", ["plain", "transmissive", "regularized",
                                  "ris9"])
def test_ineligibility_reasons_cover_jax(jax_scenes, case):
    jscene, _, scene, _ = jax_scenes("cornell")
    overrides = {"regularized": dict(path_regularization_scale=1.0),
                 "ris9": dict(next_event_sample_count=9)}.get(case, {})
    if case == "transmissive":
        jscene, scene = _transmissive(jscene), _transmissive(scene)
    jreasons = jpm.megakernel_ineligibility_reasons(
        jscene, jpt.settings_for_scene(jscene, **overrides))
    reasons = tpm.megakernel_ineligibility_reasons(
        scene, tpt.settings_for_scene(scene, **overrides))
    assert set(jreasons) <= set(reasons), (jreasons, reasons)
    assert bool(jreasons) == (case != "plain")
    assert not (set(reasons) - set(jreasons))   # nothing else on Cornell


@pytest.mark.parametrize("change, reason", [
    ("environment", "environment without presampled pool "
                    "(build_render_scene presample_environment)"),
    ("texture", "texture bindings without a texture bank"),
    ("cutout", None),
    ("triangles", f"{tpm.HIER_MAX_TRIS + 1} triangles > HIER_MAX_TRIS "
                  f"{tpm.HIER_MAX_TRIS}"),
])
def test_unported_branches_are_ineligible(jax_scenes, change, reason):
    """What keeps a changed Cornell from the megakernel now that its
    environment, texture and cutout branches are ported: a map without its
    pool, a binding without a bank, a scene over the cap; a cutout
    nothing."""
    _, _, scene, _ = jax_scenes("cornell")
    mats = scene.materials
    if change == "environment":
        from bifrost3d_tpu_torch.lights.environment import (
            build_environment_light)
        scene = scene._replace(environment=build_environment_light(
            np.full((4, 8, 3), 0.5, np.float32), device="cpu"))
    elif change == "texture":
        slot = mats.tint_roughness_texture.clone()
        slot[0] = 0
        scene = scene._replace(materials=mats._replace(
            tint_roughness_texture=slot))
    elif change == "cutout":
        flags = mats.flags.clone()
        flags[0] = 2
        scene = scene._replace(materials=mats._replace(flags=flags))
    else:
        # Above the dense branch's 1,024 triangles the BVH branch takes
        # over: no triangle-count reason up to its cap.
        mid = scene._replace(tri_verts=torch.zeros((1200, 3, 3)))
        assert not any("triangles" in r for r in
                       tpm.megakernel_ineligibility_reasons(
                           mid, tpt.RenderSettings()))
        scene = scene._replace(
            tri_verts=torch.zeros((tpm.HIER_MAX_TRIS + 1, 3, 3)))
    settings = tpt.RenderSettings()
    reasons = tpm.megakernel_ineligibility_reasons(scene, settings)
    if reason is None:
        assert reasons == []
        assert tpm.megakernel_ineligibility_reasons(
            scene, tpt.settings_for_scene(scene)) == []
        assert tpt.explain_render_path(scene, settings) == \
            "wavefront: device is cpu, not cuda"
        return
    assert reasons == [reason], reasons
    assert tpt.explain_render_path(scene, settings) == (
        "wavefront: device is cpu, not cuda, " + ", ".join(reasons))


# -- frames ----------------------------------------------------------------------

@pytest.mark.parametrize("name, accumulation", [
    ("cornell", 0), ("cornell", 3), ("coated", 0)])
def test_plain_megakernel_matches_jax_interpret(jax_scenes, jax_interpret,
                                                name, accumulation):
    _, _, scene, cam = jax_scenes(name)
    ref, _ = jax_interpret(jax_scenes, name, accumulation)
    img, _ = _port_megakernel(scene, cam, accumulation)
    assert_statistical_gate(img, ref)
    assert img.mean() > 0.01


def test_ray_count_matches_jax_megakernel(jax_scenes, jax_interpret):
    for name, accumulation in (("cornell", 0), ("cornell", 3),
                               ("coated", 0)):
        _, _, scene, cam = jax_scenes(name)
        _, jrays = jax_interpret(jax_scenes, name, accumulation)
        _, rays = _port_megakernel(scene, cam, accumulation)
        assert abs(rays - jrays) <= 0.02 * jrays, (name, rays, jrays)


def test_render_sample_fast_on_cpu_takes_the_wavefront(jax_scenes):
    _, _, scene, cam = jax_scenes("cornell")
    settings = tpt.settings_for_scene(scene, max_bounce_count=1)
    img = tpt.render_sample_fast(scene, cam, 16, 16, 0, settings)
    ref = tpt.render_sample_pooled(scene, cam, 16, 16, 0, settings)
    np.testing.assert_array_equal(img.numpy(), ref.numpy())


# -- scenes ---------------------------------------------------------------------

def _assert_same_scene(scene, ref):
    np.testing.assert_array_equal(scene.tri_normals_oct.numpy(),
                                  ref.tri_normals_oct.numpy())
    np.testing.assert_array_equal(scene.tri_material.numpy(),
                                  ref.tri_material.numpy())
    np.testing.assert_allclose(scene.tri_verts.numpy(), ref.tri_verts.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(scene.tri_uvs.numpy(), ref.tri_uvs.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(scene.tri_components.numpy(),
                               ref.tri_components.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(scene.scene_epsilon.numpy(),
                               ref.scene_epsilon.numpy(), rtol=1e-6)
    assert scene.shading_models == ref.shading_models
    for field in ref.materials._fields:
        np.testing.assert_allclose(getattr(scene.materials, field).numpy(),
                                   getattr(ref.materials, field).numpy())
    for field in ref.lights._fields:
        np.testing.assert_allclose(getattr(scene.lights, field).numpy(),
                                   getattr(ref.lights, field).numpy(),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name, build", [
    ("veach", lambda: port_scenes.create_veach_scene(device="cpu")),
    ("veach_mesh_light", lambda: port_scenes.create_veach_scene(
        with_mesh_light=True, device="cpu")),
    ("sphere_light", lambda: port_scenes.create_sphere_light_scene(
        device="cpu")),
    *[(name, lambda n=name: port_scenes.TEST_SCENES[n](device="cpu"))
      for name in ("coated", "spot", "diffuse", "emissive",
                   "directional")],
])
def test_own_build_matches_jax_scene(jax_scenes, name, build):
    _, jcam, ref, _ = jax_scenes(name)
    scene, cam = build()
    _assert_same_scene(scene, ref)
    jarr = camera_arrays(jcam)
    np.testing.assert_allclose(cam.transform.translation.numpy(),
                               jarr["translation"], atol=1e-6)
    np.testing.assert_allclose(cam.inverse_projection.numpy(),
                               jarr["inverse_projection"], rtol=1e-6)


def test_viewer_lists_the_new_scenes():
    assert {"CornellBox", "Veach", "SphereLight"} <= set(port_scenes.SCENES)
    scene, _ = port_scenes.SCENES["SphereLight"](device="cpu")
    assert int(scene.tri_verts.shape[0]) == 960
    assert tpt.explain_render_path(scene) == "wavefront: device is cpu, not cuda"
