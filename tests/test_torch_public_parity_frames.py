"""The rest of the one-gate-per-public-function list of
``test_torch_public_parity.py``: the stochastic renderers, the host-side
classes (the datamodel managers, the terminal, tick timing), the BVH and
mesh builders and the distributed set-up, each against JAX's.

- ``render_smallpt_pixels`` and ``render_smallvpt`` at 16 × 12 under
  ``assert_smallpt_gate``; ``render_sample_pixels_detached`` under
  ``assert_statistical_gate`` for its frame and, for its gradient over
  ``materials.tint``, within rtol 1e-4, atol 1e-8 with the port's
  elementary functions rounded once (``test_torch_diff_grad.py``'s gate).
  That is the file's one JAX ``value_and_grad``.
- Each datamodel manager runs one scripted sequence of its methods in
  both packages; everything it then reports (names, graph, payloads,
  transforms, change flags) must be equal.
- BVHs, mesh bounds and normals are host numpy: equal array for array.

Keys are ``module.name`` of the JAX package, as in the first file;
``tests/test_torch_imports.py`` reads both.
"""

import os
import pty
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per test worker)

from bifrost3d_tpu.apps import interactive_viewer as jiv
from bifrost3d_tpu.core import engine as jeng
from bifrost3d_tpu.diff import render_grad as jrg
from bifrost3d_tpu.geometry import bvh as jbvh
from bifrost3d_tpu.geometry import creation as jcre
from bifrost3d_tpu.geometry import mesh as jmesh
from bifrost3d_tpu.geometry import native as jnat
from bifrost3d_tpu.integrator import path_tracer as jpt
from bifrost3d_tpu.integrator import smallpt as jspt
from bifrost3d_tpu.integrator import smallvpt as jvpt
from bifrost3d_tpu.parallel import distributed as jdist
from bifrost3d_tpu.scene import spheres as jsph

from bifrost3d_tpu_torch.apps import interactive_viewer as tiv
from bifrost3d_tpu_torch.core import engine as teng
from bifrost3d_tpu_torch.diff import render_grad as trg
from bifrost3d_tpu_torch.geometry import bvh as tbvh
from bifrost3d_tpu_torch.geometry import creation as tcre
from bifrost3d_tpu_torch.geometry import mesh as tmesh
from bifrost3d_tpu_torch.geometry import native as tnat
from bifrost3d_tpu_torch.integrator import path_tracer as tpt
from bifrost3d_tpu_torch.integrator import smallpt as tspt
from bifrost3d_tpu_torch.integrator import smallvpt as tvpt
from bifrost3d_tpu_torch.parallel import distributed as tdist
from bifrost3d_tpu_torch.scene import spheres as tsph
from test_torch_datamodel import JAX, PORT, _at, _checker, _quat
from test_torch_diff_grad import SETTINGS, H, W, make_jax_camera, make_jax_scene
from test_torch_diff_replay import PIXELS, _port
from torch_parity import (
    assert_smallpt_gate,
    assert_statistical_gate,
    elementary_rounded_once,
)

CASES = {}


def case(name):
    """Register a case under the JAX name ``module.name`` it holds."""
    def register(fn):
        assert name not in CASES, name
        CASES[name] = fn
        return fn
    return register


def _plain(value):
    """A tree of numpy arrays, numbers and strings from either package's
    objects (tensors, jax arrays, UIDs, NamedTuples, dataclasses)."""
    if isinstance(value, (torch.Tensor, jax.Array)):
        return np.asarray(value.detach() if isinstance(value, torch.Tensor)
                          else value)
    if type(value).__name__ == "UID":
        return ("uid", int(value))
    if hasattr(value, "_fields"):
        return tuple(_plain(v) for v in value)
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(v) for v in value)
    if hasattr(value, "__dataclass_fields__"):
        return {k: _plain(getattr(value, k))
                for k in value.__dataclass_fields__}
    if type(value).__name__ == "PixelImage":
        return (value.format, tuple(value.size), _plain(value.data))
    return value


def _assert_same(got, want, path="value"):
    if isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.shape == want.shape and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


def _changes(manager):
    return sorted((int(u), manager.changes.get_changes(u))
                  for u in manager.changes.get_changed_resources())


# -- renderers ---------------------------------------------------------------------

@case("integrator.smallpt.render_smallpt_pixels")
def _render_smallpt_pixels(name):
    """Scattered pixels of a 16 x 12 frame at accumulations 1 and 4."""
    jscene = jsph.smallpt_scene()
    scene = tsph.smallpt_scene(device="cpu")
    rng = np.random.default_rng(16)
    x = rng.integers(0, 16, (12, 16))
    y = rng.integers(0, 12, (12, 16))
    for acc in (1, 4):
        got = tspt.render_smallpt_pixels(scene, torch.tensor(x),
                                         torch.tensor(y), 16, 12, acc)
        want = jspt.render_smallpt_pixels(
            jscene, jnp.asarray(x, jnp.uint32), jnp.asarray(y, jnp.uint32),
            16, 12, jnp.uint32(acc))
        assert got.shape == (12, 16, 3)
        assert_smallpt_gate(got.numpy(), np.asarray(want))


@case("integrator.smallvpt.render_smallvpt")
def _render_smallvpt(name):
    got = tvpt.render_smallvpt(tsph.smallvpt_scene(device="cpu"), 16, 12, 2)
    want = jvpt.render_smallvpt(jsph.smallvpt_scene(), 16, 12, 2)
    assert_smallpt_gate(got.numpy(), np.asarray(want))
    assert float(got.mean()) > 0.01


@case("integrator.path_tracer.render_sample_pixels_detached")
def _render_sample_pixels_detached(name):
    """tests/test_diff.py's scene at scattered pixels of 16 x 12: the frame,
    and the gradient of its mean over ``materials.tint``."""
    jscene, jcam = make_jax_scene(), make_jax_camera()
    x, y = PIXELS

    def jax_loss(tint):
        s = jscene._replace(materials=jscene.materials._replace(tint=tint))
        img = jpt.render_sample_pixels_detached(
            s, jcam, jnp.asarray(x), jnp.asarray(y), W, H, jnp.uint32(2),
            SETTINGS)
        return jnp.mean(img), img
    # Jitted: its compile (~50 s on the CPU) is the file's largest cost,
    # and eager AD of the wavefront takes longer still.
    (_, want), want_grad = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jscene.materials.tint)

    scene, cam = _port(jscene, jcam)

    def port_run():
        tint = scene.materials.tint.clone().requires_grad_(True)
        s = scene._replace(materials=scene.materials._replace(tint=tint))
        img = tpt.render_sample_pixels_detached(
            s, cam, torch.tensor(x.astype(np.int64)),
            torch.tensor(y.astype(np.int64)), W, H, 2,
            tpt.RenderSettings(*SETTINGS))
        img.mean().backward()
        return img.detach().numpy(), tint.grad.numpy()
    img, grad = port_run()
    assert img.shape == (6, 8, 3) and float(img.mean()) > 0.0
    assert_statistical_gate(img, np.asarray(want))
    with elementary_rounded_once():
        _, grad_once = port_run()
    assert np.abs(grad_once).max() > 0
    np.testing.assert_allclose(grad_once, np.asarray(want_grad), rtol=1e-4,
                               atol=1e-8)
    np.testing.assert_allclose(grad, np.asarray(want_grad), rtol=1e-3,
                               atol=1e-8)


@case("diff.render_grad.OptimizeResult")
def _optimize_result(name):
    """Its fields and what its constructor holds (``optimize_materials``,
    which returns it, is held in test_torch_diff_optimize.py)."""
    assert trg.OptimizeResult._fields == jrg.OptimizeResult._fields
    scene = object()
    got = trg.OptimizeResult(scene, [0.5, 0.25])
    assert got.scene is scene and got.losses == [0.5, 0.25]
    assert tuple(got) == tuple(jrg.OptimizeResult(scene, [0.5, 0.25]))


# -- geometry ----------------------------------------------------------------------

def _boxes(n=300):
    rng = np.random.default_rng(16)
    lo = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    return lo, lo + rng.uniform(0.01, 2.0, (n, 3)).astype(np.float32)


@case("geometry.bvh.build_bvh_boxes")
def _build_bvh_boxes(name):
    """Native and numpy builders, leaves of 1 and 4 boxes: bit for bit."""
    lo, hi = _boxes()
    for use_native in (True, False):
        for max_leaf in (1, 4):
            got = tbvh.build_bvh_boxes(lo, hi, max_leaf, use_native)
            want = jbvh.build_bvh_boxes(lo, hi, max_leaf, use_native)
            assert got._fields == want._fields
            _assert_same(_plain(got), _plain(want))


@case("geometry.native.build_bvh_native")
def _build_bvh_native(name):
    """The C++ builder through either package's binding: equal arrays (the
    port builds the library under build/native/)."""
    lo, hi = _boxes()
    for max_leaf in (1, 4):
        got = tnat.build_bvh_native(lo, hi, max_leaf)
        want = jnat.build_bvh_native(lo, hi, max_leaf)
        assert got is not None and want is not None
        _assert_same(_plain(got), _plain(want))


@case("geometry.mesh.mesh_aabb")
def _mesh_aabb(name):
    for make in ("make_sphere", "make_box", "make_torus"):
        got = tmesh.mesh_aabb(getattr(tcre, make)())
        want = jmesh.mesh_aabb(getattr(jcre, make)())
        _assert_same(_plain(got), _plain(want))


@case("geometry.mesh.compute_smooth_normals")
def _compute_smooth_normals(name):
    """Area-weighted vertex normals of a mesh with its normals dropped;
    ``TriangleMesh`` has JAX's fields (its ``emission`` buffer too)."""
    assert tmesh.TriangleMesh._fields == jmesh.TriangleMesh._fields
    for make in ("make_sphere", "make_box", "make_cylinder"):
        port = getattr(tcre, make)()._replace(normals=None)
        ref = getattr(jcre, make)()._replace(normals=None)
        got = tmesh.compute_smooth_normals(port)
        want = jmesh.compute_smooth_normals(ref)
        _assert_same(_plain(got), _plain(want))


# -- host-side classes -------------------------------------------------------------

@case("core.engine.Time")
def _time(name):
    """Given time steps (the first tick without one measures 0)."""
    port, ref = teng.Time(), jeng.Time()
    for t in (port, ref):
        for dt in (None, 0.5, 0.25, 1.0 / 60):
            t.tick(dt)
    assert port.ticks == ref.ticks == 4
    assert port.total == ref.total == 0.5 + 0.25 + 1.0 / 60
    assert port.delta == ref.delta


@case("apps.interactive_viewer.TerminalDisplay")
def _terminal_display(name, capsys):
    ldr = np.random.default_rng(16).uniform(0, 1, (5, 4, 3)).astype(
        np.float32)
    said = []
    for term, frame in ((jiv.TerminalDisplay(True), ldr),
                        (tiv.TerminalDisplay(True), torch.tensor(ldr))):
        term.present(frame, "status one")
        term.present(frame, "status two")
        said.append(capsys.readouterr().out)
    for term in (jiv.TerminalDisplay(False), tiv.TerminalDisplay(False)):
        term.present(ldr, "hidden")
    assert capsys.readouterr().out == ""
    assert said[1] == said[0] and said[0].startswith("\x1b[2J\x1b[H")


@case("apps.interactive_viewer.TerminalInput")
def _terminal_input(name, monkeypatch):
    """Keys written to a pseudo-terminal come back as the same names; on a
    stdin that is not a terminal both poll nothing."""
    master, slave = pty.openpty()
    with open(slave, "r", closefd=True) as tty_in:
        monkeypatch.setattr(sys, "stdin", tty_in)
        polled = []
        for cls in (jiv.TerminalInput, tiv.TerminalInput):
            with cls() as term:
                keys = []
                for chunk in (b"w", b"A", b"\x1b", b"q"):
                    os.write(master, chunk)
                    keys.append(term.poll())
                polled.append(keys)
    os.close(master)
    assert polled[1] == polled[0] == [["w"], ["a"], ["esc"], ["q"]]
    with open(os.devnull) as not_a_tty:
        monkeypatch.setattr(sys, "stdin", not_a_tty)
        for cls in (jiv.TerminalInput, tiv.TerminalInput):
            with cls() as term:
                assert term.poll() == []


@case("parallel.distributed.initialize")
def _initialize(name, monkeypatch):
    """Each field from its argument, else from ``BIFROST_COORDINATOR`` /
    ``BIFROST_NUM_PROCESSES`` / ``BIFROST_PROCESS_ID``: both packages hand
    the same coordinator, world size and rank to their runtime (recorded,
    not joined)."""
    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.__setitem__("jax", kw))
    monkeypatch.setattr(
        tdist.dist, "init_process_group",
        lambda backend, init_method, world_size, rank, timeout:
        seen.__setitem__("port", dict(init_method=init_method,
                                      world_size=world_size, rank=rank)))
    monkeypatch.setattr(tdist.torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("BIFROST_COORDINATOR", "localhost:12355")
    monkeypatch.setenv("BIFROST_NUM_PROCESSES", "4")
    monkeypatch.setenv("BIFROST_PROCESS_ID", "2")
    for kwargs in ({}, dict(num_processes=2, process_id=1),
                   dict(coordinator_address="127.0.0.1:9999")):
        monkeypatch.setattr(jdist, "_INITIALIZED", False)
        seen.clear()
        jdist.initialize(**kwargs)
        tdist.initialize(**kwargs)
        want = seen["jax"]
        assert seen["port"] == dict(
            init_method="tcp://" + want["coordinator_address"],
            world_size=want["num_processes"], rank=want["process_id"])


# -- the datamodel managers ----------------------------------------------------------

def _script_nodes(pkg):
    n = pkg.dm.SceneNodes()
    a = n.create("a", _at(pkg, [1.0, 2.0, 3.0]))
    b = n.create("b")
    c = n.create("c", _at(pkg, [0.0, 1.0, 0.0], _quat([0, 1, 0], 0.5), 2.0))
    d = n.create("d")
    n.set_parent(b, a)
    n.set_parent(c, a)
    n.set_parent(d, c)
    n.reset_change_notifications()
    n.set_global_transform(c, _at(pkg, [4.0, 5.0, 6.0]))
    visited, below = [], []
    n.apply_recursively(a, lambda u: visited.append(n.get_name(u)))
    n.apply_to_children_recursively(a, lambda u: below.append(n.get_name(u)))
    n.set_parent(c, b)
    destroyed = (n.destroy(d), n.destroy(d))
    return dict(
        visited=visited, below=below, destroyed=destroyed, len=len(n),
        has=[n.has(u) for u in (a, b, c, d)], changes=_changes(n),
        nodes=[(n.get_name(u), n.get_parent(u), n.get_children(u),
                n.get_global_transform(u)) for u in n])


def _script_roots(pkg):
    r = pkg.dm.SceneRoots()
    nodes = pkg.dm.SceneNodes()
    root = r.create("scene", nodes.create("root"))
    other = r.create("other", nodes.create("root2"),
                     environment_tint=(0.1, 0.2, 0.3))
    r.reset_change_notifications()
    r.set_environment_tint(root, [0.5, 0.6, 0.7])
    r.set_environment_map(other, np.full((4, 8, 3), 0.25, np.float32))
    return dict(changes=_changes(r), roots=[
        (r.get_root_node(u), r.get_environment_tint(u),
         r.get_environment_map(u)) for u in r])


def _script_meshes(pkg):
    m = pkg.dm.Meshes()
    sphere = m.create("sphere", pkg.creation.make_sphere(0.5, 8, 4))
    m.create("box", pkg.creation.make_box(0.7))
    m.reset_change_notifications()
    m.set_mesh(sphere, pkg.creation.make_plane(2.0))
    return dict(changes=_changes(m),
                meshes=[(m.get_name(u), m.get_mesh(u)) for u in m])


def _script_materials(pkg):
    m = pkg.dm.Materials()
    a = m.create("a", tint=(0.8, 0.3, 0.2), roughness=0.4)
    b = m.create("b", tint=(0.2, 0.6, 0.9), roughness=0.2, coat=1.0)
    m.reset_change_notifications()
    m.set_tint(a, (0.1, 0.2, 0.3))
    m.set_roughness(a, 0.9)
    m.set_metallic(b, 1.0)
    m.set_coverage(b, 0.5)
    m.set_emission(a, (1.0, 2.0, 3.0))
    m.set_param(b, "specularity", 0.08)
    return dict(changes=_changes(m), params=[m.get_params(u) for u in m])


def _script_images(pkg):
    i = pkg.dm.Images()
    rgb = i.create("rgb", np.full((2, 3, 3), 0.5, np.float32))
    i.create("grey", np.linspace(0, 1, 6, dtype=np.float32).reshape(2, 3))
    i.create("rgba", _checker())
    i.reset_change_notifications()
    i.set_image(rgb, i.get_image(rgb))
    return dict(changes=_changes(i),
                images=[(i.get_name(u), i.get_image(u)) for u in i])


def _script_textures(pkg):
    images = pkg.dm.Images()
    img = images.create("checker", _checker())
    t = pkg.dm.Textures()
    t.create(img)
    t.create(img, magnification_filter=0)
    return dict(changes=_changes(t), samplers=[
        (t.get_sampler(u), t.get_image_uid(u)) for u in t])


def _script_models(pkg):
    m = pkg.dm.MeshModels()
    nodes, meshes, mats = (pkg.dm.SceneNodes(), pkg.dm.Meshes(),
                           pkg.dm.Materials())
    node = nodes.create("n")
    mesh = meshes.create("box", pkg.creation.make_box(1.0))
    mat = mats.create("m", tint=(1.0, 1.0, 1.0))
    first = m.create(node, mesh, mat)
    m.create(node, mesh, mat)
    m.destroy(first)
    return dict(changes=_changes(m), bindings=[m.get_binding(u) for u in m])


def _script_lights(pkg):
    lights = pkg.dm.LightSources()
    nodes = pkg.dm.SceneNodes()
    node = nodes.create("l")
    s = lights.create_sphere_light(node, (50, 50, 50), 0.3)
    lights.create_spot_light(node, (30, 20, 10), 0.2, 0.6)
    lights.create_directional_light(node, (2.0, 1.8, 1.5))
    lights.create_sphere_light(node, (5, 5, 5), 0.0)
    lights.reset_change_notifications()
    lights.set_power(s, [10, 20, 30])
    return dict(changes=_changes(lights), lights=[
        (lights.get_light(u), lights.is_delta_light(u)) for u in lights])


def _script_cameras(pkg, image):
    c = pkg.dm.Cameras()
    root = pkg.dm.SceneRoots().create("scene", pkg.dm.SceneNodes().create("r"))
    a = c.create("a", root, z_index=2)
    b = c.create("b", root, _at(pkg, [0.0, 1.0, -3.0]), fov_radians=0.7,
                 aspect=1.5, z_index=1)
    c.reset_change_notifications()
    c.set_transform(a, _at(pkg, [1.0, 0.0, -2.0], _quat([0, 1, 0], 0.3)))
    c.set_renderer(b, 3)
    c.request_screenshot(a, content="ldr", minimum_iteration_count=2)
    requested = c.is_screenshot_requested(a)
    c.fill_screenshot(a, image, 1)      # too few iterations: kept waiting
    waiting = c.is_screenshot_requested(a)
    c.fill_screenshot(a, image, 4)
    shots = c.resolve_screenshot(a)
    return dict(
        changes=_changes(c), requested=requested, waiting=waiting,
        shots=shots, again=c.resolve_screenshot(a),
        order=c.get_z_sorted_ids(),
        cameras=[(c.get_transform(u), c.get_renderer(u), c.get_z_index(u))
                 for u in c])


def _manager_case(name, script):
    def run(name):
        _assert_same(_plain(script(PORT)), _plain(script(JAX)))
    case(name)(run)


_manager_case("scene.datamodel.SceneNodes", _script_nodes)
_manager_case("scene.datamodel.SceneRoots", _script_roots)
_manager_case("scene.datamodel.Meshes", _script_meshes)
_manager_case("scene.datamodel.Materials", _script_materials)
_manager_case("scene.datamodel.Images", _script_images)
_manager_case("scene.datamodel.Textures", _script_textures)
_manager_case("scene.datamodel.MeshModels", _script_models)
_manager_case("scene.datamodel.LightSources", _script_lights)


@case("scene.datamodel.Cameras")
def _cameras(name):
    """The scripted cameras, and ``to_pinhole`` of each (float32 on both
    sides: ``perspective_projection`` builds float32 matrices)."""
    image = np.random.default_rng(16).uniform(0, 1, (4, 4, 3)).astype(
        np.float32)
    port = _script_cameras(PORT, torch.tensor(image))
    ref = _script_cameras(JAX, jnp.asarray(image))
    _assert_same(_plain(port), _plain(ref))
    c = PORT.dm.Cameras()
    root = PORT.dm.SceneRoots().create("s", PORT.dm.SceneNodes().create("r"))
    jc = JAX.dm.Cameras()
    jroot = JAX.dm.SceneRoots().create("s", JAX.dm.SceneNodes().create("r"))
    uid = c.create("a", root, _at(PORT, [0.0, 1.0, -3.0]), aspect=1.5)
    juid = jc.create("a", jroot, _at(JAX, [0.0, 1.0, -3.0]), aspect=1.5)
    got = c.to_pinhole(uid, device="cpu")
    want = jc.to_pinhole(juid)
    for a, b in zip(torch.utils._pytree.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


_FIXTURES = {"apps.interactive_viewer.TerminalDisplay": "capsys",
             "apps.interactive_viewer.TerminalInput": "monkeypatch",
             "parallel.distributed.initialize": "monkeypatch"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_public_function_matches_jax(name, request):
    fixture = _FIXTURES.get(name)
    if fixture:
        CASES[name](name, request.getfixturevalue(fixture))
    else:
        CASES[name](name)
