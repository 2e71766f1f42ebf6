"""The port's datamodel and SceneSync against the JAX package's.

One seeded script builds the same datamodel through either package's API
(``_build`` takes the package's modules as an argument). ``SceneSync``'s
``RenderScene`` must equal JAX's array for array: soup, BVH and dense
table bit for bit, materials, lights and textures equal. Each of
``handle_updates``' five branches (materials only, lights only, node
transforms only, scene roots, anything else) must rebuild what JAX's
rebuilds and reuse by identity what JAX's reuses. The rest mirrors
``tests/test_core.py``'s scene-graph, sync and refit cases.
"""

from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per test worker)

from bifrost3d_tpu.apps import interactive_viewer as jax_viewer
from bifrost3d_tpu.geometry import creation as jax_creation
from bifrost3d_tpu.math import transform as jax_transform
from bifrost3d_tpu.scene import datamodel as jax_datamodel

from bifrost3d_tpu_torch.apps import interactive_viewer
from bifrost3d_tpu_torch.geometry import creation
from bifrost3d_tpu_torch.geometry.creation import make_sphere
from bifrost3d_tpu_torch.math import transform
from bifrost3d_tpu_torch.math.transform import transform_identity
from bifrost3d_tpu_torch.scene import datamodel
from bifrost3d_tpu_torch.scene.datamodel import SceneData, SceneSync

CPU = torch.device("cpu")

PORT = SimpleNamespace(dm=datamodel, creation=creation, tr=transform,
                       array=lambda a: torch.tensor(np.asarray(a, np.float32)),
                       viewer=interactive_viewer,
                       sync=lambda d: SceneSync(d, device=CPU))
JAX = SimpleNamespace(dm=jax_datamodel, creation=jax_creation,
                      tr=jax_transform,
                      array=lambda a: jnp.asarray(np.asarray(a, np.float32)),
                      viewer=jax_viewer, sync=jax_datamodel.SceneSync)


def _quat(axis, angle):
    """A unit quaternion made once in numpy, so both packages take the
    same bits (their sin and cos round differently)."""
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    return np.concatenate([axis * np.sin(angle / 2), [np.cos(angle / 2)]])


def _at(pkg, translation, rotation=(0.0, 0.0, 0.0, 1.0), scale=1.0):
    return pkg.tr.transform_identity()._replace(
        translation=pkg.array(translation), rotation=pkg.array(rotation),
        scale=pkg.array(scale))


def _checker():
    checker = np.zeros((2, 2, 4), np.float32)
    checker[..., 3] = 0.8
    checker[0, 0, 0] = checker[1, 1, 0] = 1.0
    checker[0, 1, 2] = checker[1, 0, 2] = 1.0
    return checker


def _build(pkg, name):
    """The datamodel of scene ``name`` through ``pkg``'s API → (data,
    handles)."""
    if name in ("Sphere", "Box"):
        data, cam = pkg.viewer.build_scene(name)
        return data, dict(camera=cam)
    rng = np.random.default_rng(14)
    d = pkg.dm.SceneData()
    root = d.nodes.create("root")
    d.roots.create("scene", root, environment_tint=(0.3, 0.4, 0.5))
    h = {}
    if name == "textured_plane":
        img = d.images.create("checker", _checker())
        tex = d.textures.create(img, magnification_filter=0)
        mesh = d.meshes.create("floor", pkg.creation.make_plane(size=2.0))
        h["material"] = d.materials.create(
            "floor", tint=(1.0, 1.0, 1.0), roughness=0.9,
            tint_roughness_texture=tex)
        h["node"] = d.nodes.create("obj")
        d.nodes.set_parent(h["node"], root)
        d.models.create(h["node"], mesh, h["material"])
        light = d.nodes.create("light", _at(pkg, [0.0, 3.0, 0.0]))
        h["light"] = d.lights.create_sphere_light(light, (60, 60, 60), 0.3)
        return d, h
    # "mixed": rotated and scaled instances, three light kinds.
    meshes = [d.meshes.create("sphere", pkg.creation.make_sphere(0.5, 12, 6)),
              d.meshes.create("box", pkg.creation.make_box(0.7)),
              d.meshes.create("cylinder", pkg.creation.make_cylinder(
                  0.3, 1.0, 10))]
    mats = [d.materials.create("a", tint=(0.8, 0.3, 0.2), roughness=0.4),
            d.materials.create("b", tint=(0.2, 0.6, 0.9), roughness=0.2,
                               coat=1.0, coat_roughness=0.1),
            d.materials.create("c", tint=(0.9, 0.9, 0.9), roughness=0.7,
                               metallic=1.0)]
    h["material"] = mats[0]
    nodes = []
    for i in range(5):
        node = d.nodes.create(f"n{i}", _at(
            pkg, rng.uniform(-2, 2, 3),
            _quat(rng.normal(size=3), rng.uniform(0, np.pi)),
            rng.uniform(0.5, 1.5)))
        d.nodes.set_parent(node, root)
        d.models.create(node, meshes[i % 3], mats[(i + 1) % 3])
        nodes.append(node)
    h["node"] = nodes[1]
    lit = [d.nodes.create("l0", _at(pkg, [0.0, 3.0, 0.0])),
           d.nodes.create("l1", _at(pkg, [1.0, 2.0, -1.0])),
           d.nodes.create("l2", _at(pkg, [0.0, 0.0, 0.0],
                                    _quat([1.0, 0.2, 0.0], 2.2)))]
    h["light"] = d.lights.create_sphere_light(lit[0], (50, 50, 50), 0.3)
    d.lights.create_spot_light(lit[1], (30, 20, 10), 0.2, 0.6)
    d.lights.create_directional_light(lit[2], (2.0, 1.8, 1.5))
    h["lit_nodes"] = lit
    return d, h


def _leaves(tree) -> dict:
    """name → leaf, one level into NamedTuple fields."""
    out = {}
    for name, value in tree._asdict().items():
        if hasattr(value, "_fields"):
            for sub, leaf in value._asdict().items():
                out[f"{name}.{sub}"] = leaf
        out[name] = value
    return out


_SKIP = ("environment", "environment_presampled", "tri_clustered")


def _assert_scenes_equal(port, ref):
    """The port's RenderScene against JAX's, array for array."""
    pl, jl = _leaves(port), _leaves(ref)
    for name, leaf in pl.items():
        if name.split(".")[0] in _SKIP or hasattr(leaf, "_fields"):
            continue
        want = jl[name]
        assert (leaf is None) == (want is None), name
        if leaf is None:
            continue
        a, b = leaf.numpy(), np.asarray(want)
        assert (a.shape, a.dtype) == (b.shape, b.dtype), (name, a.dtype,
                                                          b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in _SKIP:
        assert (getattr(port, name) is None) == (getattr(ref, name) is None)
    if ref.environment is not None:
        np.testing.assert_array_equal(port.environment.image.numpy(),
                                      np.asarray(ref.environment.image))


def _reused(new, old) -> dict:
    """name → whether the sync kept that part of the scene by identity."""
    nl, ol = _leaves(new), _leaves(old)
    return {k: nl[k] is ol[k] for k in nl if k in ol}


@pytest.mark.parametrize("name", ["Sphere", "Box", "textured_plane",
                                  "mixed"])
def test_render_scene_equals_jax(name):
    port = PORT.sync(_build(PORT, name)[0]).handle_updates()
    ref = JAX.sync(_build(JAX, name)[0]).handle_updates()
    _assert_scenes_equal(port, ref)
    assert port.tri_verts.device == CPU


def _sky():
    rng = np.random.default_rng(3)
    return rng.uniform(0.1, 2.0, (8, 16, 3)).astype(np.float32)


def _edit(pkg, d, h, edit):
    if edit == "material":
        d.materials.set_tint(h["material"], (0.9, 0.1, 0.1))
        d.materials.set_roughness(h["material"], 0.25)
    elif edit == "light":
        d.lights.set_power(h["light"], (10, 20, 30))
    elif edit == "node":
        d.nodes.set_global_transform(h["node"], _at(
            pkg, [0.5, 0.2, -0.3], _quat([0.0, 1.0, 0.3], 0.7), 1.2))
        for node in h["lit_nodes"][1:]:
            d.nodes.set_global_transform(node, _at(
                pkg, [0.2, 2.5, 0.1], _quat([0.3, 0.0, 1.0], 1.1)))
    elif edit == "roots_tint":
        d.roots.set_environment_tint(list(d.roots)[0], (1.0, 0.5, 0.25))
    elif edit == "roots_map":
        d.roots.set_environment_map(list(d.roots)[0], _sky())
    else:
        mesh = d.meshes.create("more", pkg.creation.make_torus(0.6, 0.2, 8, 6))
        node = d.nodes.create("more", _at(pkg, [0.0, 1.0, 1.0]))
        d.models.create(node, mesh, h["material"])


EDITS = ["material", "light", "node", "roots_tint", "roots_map", "rebuild"]


@pytest.mark.parametrize("edit", EDITS)
def test_incremental_sync_matches_jax(edit):
    """Each branch of handle_updates: the same arrays as JAX's after the
    edit, and by identity the same parts reused."""
    scenes, reuse = {}, {}
    for key, pkg in (("port", PORT), ("jax", JAX)):
        d, h = _build(pkg, "mixed")
        sync = pkg.sync(d)
        before = sync.handle_updates()
        d.reset_change_notifications()
        sync.accumulations = 5
        assert sync.handle_updates() is before and sync.accumulations == 5
        _edit(pkg, d, h, edit)
        after = sync.handle_updates()
        assert after is not before and sync.accumulations == 0
        scenes[key], reuse[key] = after, _reused(after, before)
    _assert_scenes_equal(scenes["port"], scenes["jax"])
    assert reuse["port"] == reuse["jax"]
    kept = {k for k, v in reuse["port"].items() if v and k != "environment"
            and k != "environment_presampled" and k != "tri_clustered"}
    if edit in ("material", "light"):
        assert {"tri_verts", "bvh", "tri_components", "textures"} <= kept
    if edit == "node":
        assert {"bvh.node_a", "bvh.prim_indices", "materials",
                "textures"} <= kept and "tri_verts" not in kept
    if edit == "rebuild":
        assert "tri_verts" not in kept and "materials" not in kept


class TestSceneGraph:
    def test_hierarchy_and_traversal(self):
        d = SceneData()
        root = d.nodes.create("root")
        a = d.nodes.create("a")
        b = d.nodes.create("b")
        c = d.nodes.create("c")
        d.nodes.set_parent(a, root)
        d.nodes.set_parent(b, root)
        d.nodes.set_parent(c, a)
        visited = []
        d.nodes.apply_recursively(
            root, lambda u: visited.append(d.nodes.get_name(u)))
        assert visited[0] == "root"
        assert set(visited) == {"root", "a", "b", "c"}
        assert visited.index("c") == visited.index("a") + 1


def _populated():
    d = SceneData()
    root = d.nodes.create("root")
    d.roots.create("scene", root, environment_tint=(0.2, 0.2, 0.2))
    mesh = d.meshes.create("sphere", make_sphere(radius=0.5))
    mat = d.materials.create("grey", tint=(0.5, 0.5, 0.5), roughness=0.6)
    node = d.nodes.create("obj")
    d.nodes.set_parent(node, root)
    d.models.create(node, mesh, mat)
    light_node = d.nodes.create("light", transform_identity()._replace(
        translation=torch.tensor([0.0, 3.0, 0.0])))
    d.lights.create_sphere_light(light_node, (50, 50, 50), 0.3)
    return d, mat, node


def test_created_and_destroyed_same_tick():
    d, _, _ = _populated()
    sync = SceneSync(d, device=CPU)
    sync.handle_updates()
    d.reset_change_notifications()
    m = d.meshes.create("tmp", make_sphere(radius=0.1))
    d.meshes.destroy(m)
    scene = sync.handle_updates()
    assert not d.meshes.has(m)
    assert scene.lights.count == 1


def test_refit_matches_full_rebuild_render():
    """A refit scene renders the frame a full rebuild renders."""
    from bifrost3d_tpu_torch.integrator.path_tracer import (
        render_sample, settings_for_scene)
    from bifrost3d_tpu_torch.scene.camera import perspective_camera
    d, _, node = _populated()
    sync = SceneSync(d, device=CPU)
    sync.handle_updates()
    d.reset_change_notifications()
    d.nodes.set_global_transform(node, transform_identity()._replace(
        translation=torch.tensor([0.5, 0.2, 0.0])))
    refit = sync.handle_updates()
    rebuilt = SceneSync(d, device=CPU).handle_updates()
    assert refit.bvh.node_a is not rebuilt.bvh.node_a
    cam = perspective_camera((0, 0.5, -3.0), (0.5, 0.2, 0), device=CPU)
    s = settings_for_scene(refit, max_bounce_count=1)
    a = render_sample(refit, cam, 16, 16, 0, s)
    b = render_sample(rebuilt, cam, 16, 16, 0, s)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_screenshot_holds_the_frame_of_its_fill():
    d, _, _ = _populated()
    root = list(d.roots)[0]
    cam = d.cameras.create("main", d.roots.get_root_node(root))
    d.cameras.request_screenshot(cam, content="hdr")
    image = torch.full((4, 4, 3), 0.5)
    d.cameras.fill_screenshot(cam, image, 1)
    image.add_(1.0)                     # the renderer writes its buffer again
    (shot,) = d.cameras.resolve_screenshot(cam)
    assert bool((shot["image"] == 0.5).all())
    assert shot["iterations"] == 1 and not d.cameras.is_screenshot_requested(
        cam)


def test_to_pinhole_equals_jax():
    port_data, port_h = _build(PORT, "Sphere")
    jax_data, jax_h = _build(JAX, "Sphere")
    port = port_data.cameras.to_pinhole(port_h["camera"], device=CPU)
    ref = jax_data.cameras.to_pinhole(jax_h["camera"])
    for a, b in zip((*port.transform, port.projection,
                     port.inverse_projection),
                    (*ref.transform, ref.projection, ref.inverse_projection)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("edit", EDITS)
def test_megakernel_tables_follow_the_sync(edit):
    """The megakernel's geometry pack is rebuilt only where SceneSync
    rebuilt the geometry; its frame tables after every edit."""
    from bifrost3d_tpu_torch.integrator import pallas_mesh as mega
    from bifrost3d_tpu_torch.integrator.path_tracer import RenderSettings
    d, h = _build(PORT, "mixed")
    sync = PORT.sync(d)
    settings = RenderSettings(max_bounce_count=2)
    mega._frame_tables(sync.handle_updates(), settings)
    d.reset_change_notifications()
    packs, frames = mega._PACK_CACHE.stores, mega._FRAME_CACHE.stores
    mega._frame_tables(sync.handle_updates(), settings)
    assert (mega._PACK_CACHE.stores, mega._FRAME_CACHE.stores) == (packs,
                                                                   frames)
    _edit(PORT, d, h, edit)
    mega._frame_tables(sync.handle_updates(), settings)
    repacked = edit in ("node", "rebuild")
    assert mega._PACK_CACHE.stores == packs + repacked
    assert mega._FRAME_CACHE.stores == frames + 1
