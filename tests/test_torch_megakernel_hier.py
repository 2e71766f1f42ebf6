"""The port's mesh megakernel above 1,024 triangles (its BVH branch) against
the JAX package, on the CPU.

On CPU tensors ``render_mesh_megakernel`` runs the kernel's plain PyTorch
version, whose trace above ``MAX_TRIS`` is the lockstep walk over the
port's packed triangle BVH with the attributes gathered by slot. It is held
against the JAX megakernel's hier branch in Pallas interpret mode (one run
for the whole file: it is the slow part; the port's own ``render_sample``
as a second reference is in tests/test_torch_megakernel_hier_frames.py) on
the very same scene arrays (the JAX
``tests/test_pallas_mesh.py::_mid_size_scene``, 2,494 triangles, carried
across with ``render_scene_from_numpy``), at 32² and 2 bounces, under the
statistical gate of tests/test_pallas_mesh.py:25-42 (at most 3% of pixels
off by more than 1e-3, means within 2%): float reassociation and another
tie rule can flip individual stochastic decisions, while the RNG chains are
bit-exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bifrost3d_tpu.apps.scenes import _trs
from bifrost3d_tpu.geometry.pallas_bvh import (
    pack_hierarchical as jax_pack_hierarchical)
from bifrost3d_tpu.integrator import pallas_mesh as jpm
from bifrost3d_tpu.integrator import path_tracer as jpt

from bifrost3d_tpu_torch.apps import scenes as port_scenes
from bifrost3d_tpu_torch.geometry import pallas_bvh as thier
from bifrost3d_tpu_torch.geometry import creation as tcreation
from bifrost3d_tpu_torch.integrator import pallas_mesh as tpm
from bifrost3d_tpu_torch.integrator import path_tracer as tpt
from bifrost3d_tpu_torch.lights.types import LightArray
from bifrost3d_tpu_torch.scene import render_scene as trs
from bifrost3d_tpu_torch.scene.camera import camera_from_numpy
from bifrost3d_tpu_torch.scene.materials import MaterialArray, dielectric
from torch_parity import assert_statistical_gate, camera_arrays, scene_arrays

RES = 32
BOUNCES = 2
MID_SIZE_TRIS = 2494


def _jax_mid_size_scene():
    """tests/test_pallas_mesh.py:287-315, built by the JAX package."""
    from bifrost3d_tpu.geometry.creation import (make_box, make_plane,
                                                 make_sphere)
    from bifrost3d_tpu.lights.types import LIGHT_SPHERE
    from bifrost3d_tpu.lights.types import LightArray as JLightArray
    from bifrost3d_tpu.scene.camera import perspective_camera
    from bifrost3d_tpu.scene.materials import MaterialArray as JMaterialArray
    from bifrost3d_tpu.scene.materials import dielectric as jdielectric
    from bifrost3d_tpu.scene.materials import metal
    from bifrost3d_tpu.scene.render_scene import build_render_scene

    mats = JMaterialArray.build([jdielectric((0.7, 0.7, 0.7), 0.6),
                                 metal((0.95, 0.64, 0.54), 0.3),
                                 jdielectric((0.2, 0.4, 0.8), 0.2)])
    instances = [
        (make_plane(size=4.0), 0, _trs((0, -0.5, 0))),
        (make_sphere(slices=40, stacks=20), 1, _trs((-0.5, 0.0, 0.2))),
        (make_sphere(slices=32, stacks=16), 2, _trs((0.6, -0.1, -0.2))),
        (make_box(size=0.5), 0, _trs((0.0, -0.3, -0.8)))]
    lights = JLightArray.build([{"kind": LIGHT_SPHERE,
                                 "position": (0.0, 1.6, 0.5), "radius": 0.2,
                                 "power": (40.0,) * 3}])
    scene = build_render_scene(instances, mats, lights)
    return scene, perspective_camera((0.0, 0.6, 2.4), (0.0, -0.1, 0.0))


@pytest.fixture(scope="module")
def mid_size():
    """(JAX scene, JAX camera, port scene, port camera), the port's carried
    across from the JAX arrays, BVH included."""
    jscene, jcam = _jax_mid_size_scene()
    return (jscene, jcam,
            trs.render_scene_from_numpy(scene_arrays(jscene), device="cpu"),
            camera_from_numpy(camera_arrays(jcam), device="cpu"))


@pytest.fixture(scope="module")
def jax_interpret(mid_size):
    """(image, rays) of the JAX megakernel's hier branch in interpret mode,
    rendered once."""
    jscene, jcam, _, _ = mid_size
    settings = jpt.settings_for_scene(jscene, max_bounce_count=BOUNCES)
    assert jpm.mesh_megakernel_eligible(jscene, settings)
    img, rays = jpm.render_mesh_megakernel(jscene, jcam, RES, RES,
                                           jnp.uint32(0), settings,
                                           interpret=True)
    return np.asarray(img), float(rays)


@pytest.fixture(scope="module")
def plain_frame(mid_size):
    """(image, rays) of the port's plain hier version, once."""
    _, _, scene, cam = mid_size
    settings = tpt.settings_for_scene(scene, max_bounce_count=BOUNCES)
    assert tpm.mesh_megakernel_eligible(scene, settings), \
        tpm.megakernel_ineligibility_reasons(scene, settings)
    before = tpm.launch_count
    img, rays = tpm.render_mesh_megakernel(scene, cam, RES, RES, 0, settings)
    assert tpm.launch_count == before        # CPU tensors: the plain version
    assert img.shape == (RES, RES, 3)
    return img.numpy(), float(rays)


# -- tables ------------------------------------------------------------------------

def test_packed_tables_match_jax(mid_size):
    """Both packages pack the attribute table in their tree's slot order.
    The trees differ (JAX: 128-triangle clusters, slots padded; the port:
    the triangle BVH itself), so columns are compared by the triangle they
    belong to."""
    jscene, _, scene, _ = mid_size
    t = int(scene.tri_verts.shape[0])
    assert t == MID_SIZE_TRIS > tpm.MAX_TRIS
    jpacked = jpm._pack_scene(jscene)
    packed = tpm._pack_scene(scene)
    assert packed["hier"] and jpacked["hier"] and packed["n_tris"] == t
    tree, attr = packed["tri"], packed["attr"].numpy()
    assert isinstance(tree, thier.HierTriangles)
    assert attr.shape == (tpm.ATTR_ROWS, t)
    assert tree.tri_components.shape == (t, 12)
    # The walk answers with slots: the packed order is the identity.
    assert torch.equal(tree.order, torch.arange(t, dtype=torch.int32))
    order = thier.pack_hierarchical(scene.tri_verts, scene.bvh).order.numpy()
    np.testing.assert_array_equal(np.sort(order), np.arange(t))
    # Row 9 is the material of the slot's triangle (test_pallas_mesh.py:338-345).
    np.testing.assert_array_equal(
        attr[9], scene.tri_material.numpy()[order].astype(np.float32))
    # JAX's valid slots, by original triangle id.
    jhp = jax_pack_hierarchical(np.asarray(jscene.tri_verts), jscene.bvh,
                                cluster_t=jpm.HIER_CLUSTER)
    jorder = np.asarray(jhp.order)
    jvalid = np.abs(np.asarray(jhp.tri_components)[3:9]).sum(axis=0) > 0
    jslot_of = np.full(t, -1)
    jslot_of[jorder[jvalid]] = np.nonzero(jvalid)[0]
    assert (jslot_of >= 0).all()
    slot_of = np.empty(t, np.int64)
    slot_of[order] = np.arange(t)
    np.testing.assert_allclose(attr[:, slot_of],
                               np.asarray(jpacked["attr"])[:, jslot_of],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tree.tri_components.numpy()[slot_of, 0:9],
                               np.asarray(jpacked["tri"])[jslot_of, 0:9],
                               rtol=1e-6, atol=1e-6)
    assert tpm._pack_scene(scene) is packed          # cached per identity


def test_scene_tree_is_reused_and_a_missing_one_is_built(mid_size,
                                                         monkeypatch):
    _, _, scene, _ = mid_size
    own = tpm._pack_scene(scene)["tri"]
    # A scene that carries the BVH kernel's packing hands it to the
    # megakernel: no second tree.
    tree = thier.pack_hierarchical(scene.tri_verts, scene.bvh)
    carrying = scene._replace(tri_verts=scene.tri_verts.clone(),
                              tri_clustered=tree)
    monkeypatch.setattr(tpm, "pack_hierarchical", None)
    packed = tpm._pack_scene(carrying)["tri"]
    assert packed.node_boxes is tree.node_boxes
    assert packed.tri_components is tree.tri_components
    monkeypatch.undo()
    # A scene without a BVH (carried over without one, at most 65,536
    # triangles) gets one built with the pack: the same construction, the same
    # tree.
    bare = scene._replace(tri_verts=scene.tri_verts.clone(), bvh=None)
    assert bare.tri_clustered is None
    built = tpm._pack_scene(bare)["tri"]
    assert torch.equal(built.node_boxes, own.node_boxes)
    assert torch.equal(built.tri_components, own.tri_components)
    assert built.max_depth == own.max_depth


def test_packing_refuses_a_tree_deeper_than_the_stack(mid_size, monkeypatch):
    _, _, scene, _ = mid_size
    monkeypatch.setattr(thier, "STACK_SIZE", 4)
    with pytest.raises(ValueError, match="exceeds the kernel stack"):
        tpm._pack_scene(scene._replace(tri_verts=scene.tri_verts.clone()))


def test_prewarm_packs_the_tree(mid_size):
    _, _, scene, _ = mid_size
    tpm._PACK_CACHE.clear()
    tpm.prewarm_megakernel(scene)            # on the CPU: no kernel build
    (packed,) = tpm._PACK_CACHE.values()
    assert packed["hier"] and isinstance(packed["tri"], thier.HierTriangles)


def test_refit_scene_packs_its_new_geometry():
    """refit_render_scene replaces tri_verts, so the identity-keyed cache
    packs the moved scene anew: the megakernel sees the torus where it
    is."""
    torus = tcreation.make_torus(major_segments=40, minor_segments=20)
    plane = tcreation.make_plane(size=6.0)
    mats = MaterialArray.build([dielectric((0.7, 0.7, 0.7), 0.5)],
                               device="cpu")
    lights = LightArray.build([], device="cpu")

    def instances(x):
        return [(plane, 0, port_scenes._trs((0, -0.5, 0))),
                (torus, 0, port_scenes._trs((x, 0.5, 0)))]

    scene = trs.build_render_scene(instances(0.0), mats, lights, device="cpu")
    assert tpm.MAX_TRIS < scene.tri_verts.shape[0] and scene.tri_clustered is None
    before = tpm._pack_scene(scene)
    moved = trs.refit_render_scene(scene, instances(1.0))
    fresh = trs.build_render_scene(instances(1.0), mats, lights, device="cpu")
    packed = tpm._pack_scene(moved)
    assert packed is not before and packed["hier"]
    # The refit keeps the topology, so slots line up with the old tree's.
    assert torch.equal(packed["tri"].node_meta, before["tri"].node_meta)
    assert not torch.equal(packed["tri"].tri_components,
                           before["tri"].tri_components)
    o = torch.tensor([[1.0, 3.0, 0.9], [0.0, 3.0, 0.9]])
    d = torch.tensor([[0.0, -1.0, 0.0]] * 2)
    got = thier.hierarchical_intersect(packed["tri"], o, d, 1e-4, float("inf"))
    ref = thier.hierarchical_intersect(tpm._pack_scene(fresh)["tri"], o, d,
                                       1e-4, float("inf"))
    torch.testing.assert_close(got.t, ref.t, rtol=1e-5, atol=0.0)
    assert got.t[0] < 2.4 < got.t[1]         # the torus moved under ray 0


# -- eligibility ---------------------------------------------------------------

def test_mid_size_scene_is_eligible_and_the_cap_gates_out(mid_size):
    jscene, _, scene, _ = mid_size
    settings = tpt.settings_for_scene(scene, max_bounce_count=BOUNCES)
    assert tpm.megakernel_ineligibility_reasons(scene, settings) == []
    assert tpm.mesh_megakernel_eligible(scene, settings)
    # Still the wavefront on the CPU, and the device is the only reason.
    assert tpt.explain_render_path(scene, settings) == \
        "wavefront: device is cpu, not cuda"
    assert tpm.HIER_MAX_TRIS == jpm.HIER_MAX_TRIS == 262144
    too_many = tpm.HIER_MAX_TRIS + 1
    fake = scene._replace(tri_verts=torch.zeros((too_many, 3, 3)))
    reasons = tpm.megakernel_ineligibility_reasons(fake, settings)
    jreasons = jpm.megakernel_ineligibility_reasons(
        jscene._replace(tri_verts=jnp.zeros((too_many, 3, 3), jnp.float32)),
        jpt.settings_for_scene(jscene))
    assert reasons == jreasons == [
        f"{too_many} triangles > HIER_MAX_TRIS {tpm.HIER_MAX_TRIS}"]
    at_cap = scene._replace(tri_verts=torch.zeros((tpm.HIER_MAX_TRIS, 3, 3)))
    assert tpm.megakernel_ineligibility_reasons(at_cap, settings) == []


# -- lanes ---------------------------------------------------------------------

def test_pixel_order_tiles_the_frame():
    order = tpm.pixel_order(16, 8, (8, 4), torch.device("cpu"))
    assert sorted(order.tolist()) == list(range(128))
    first = order[:32].reshape(4, 8)          # a warp: 8 wide, 4 high
    assert torch.equal(first, torch.arange(8) + 16 * torch.arange(4)[:, None])
    assert int(order[32]) == 8                # the next tile to the right
    assert int(order[64]) == 4 * 16           # then the next row of tiles
    raster = torch.arange(15 * 8)
    assert torch.equal(tpm.pixel_order(15, 8, (8, 4), torch.device("cpu")),
                       raster)                # a frame the tile does not divide
    assert torch.equal(tpm.pixel_order(15, 8, None, torch.device("cpu")),
                       raster)


# -- frames ----------------------------------------------------------------------

def test_plain_hier_matches_jax_interpret(plain_frame, jax_interpret):
    img, rays = plain_frame
    ref, jrays = jax_interpret
    assert_statistical_gate(img, ref)
    assert img.mean() > 0.01
    assert abs(rays - jrays) <= 0.02 * jrays, (rays, jrays)


def test_plain_hier_reports_its_walks(mid_size):
    """The plain version sums the BVH walks' box and triangle tests over the
    frame; dead lanes enter with t_max = 0 and test the root's box only."""
    _, _, scene, cam = mid_size
    settings = tpt.settings_for_scene(scene, max_bounce_count=1)
    args = tpm.megakernel_inputs(scene, cam, 8, 8, 0, settings)
    assert args[-1].hier and args[-1].n_tris == MID_SIZE_TRIS
    stats = {}
    r, g, b, rays = tpm.mesh_megakernel_reference(*args, stats=stats)
    lanes = 64
    assert float(rays.sum()) >= 2 * lanes
    assert stats["box_tests"] > stats["tri_tests"] > 0
    assert stats["box_tests"] >= lanes
    # With every lane dead nothing is traced beyond the root.
    dead = {}
    out = tpm.mesh_megakernel_reference(
        *args[:9], torch.zeros_like(args[9]), *args[10:], stats=dead)
    assert float(out[3].sum()) == 0.0 and dead["tri_tests"] == 0
    assert float(torch.stack(out[:3]).abs().sum()) == 0.0


def test_dense_table_with_the_hier_flag_is_refused(mid_size):
    _, _, scene, cam = mid_size
    settings = tpt.settings_for_scene(scene, max_bounce_count=1)
    args = tpm.megakernel_frame_inputs(scene, cam, 8, 8, 0, settings)
    with pytest.raises(TypeError, match="packed BVH"):
        tpm.mesh_megakernel_cuda(*args[:-1], args[-1]._replace(hier=False))


# -- scenes ---------------------------------------------------------------------

def test_own_mid_size_scene_matches_jax(mid_size):
    _, jcam, ref, _ = mid_size
    scene, cam = port_scenes.TEST_SCENES["mid_size"](device="cpu")
    assert int(scene.tri_verts.shape[0]) == MID_SIZE_TRIS
    np.testing.assert_allclose(scene.tri_verts.numpy(), ref.tri_verts.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(scene.tri_material.numpy(),
                                  ref.tri_material.numpy())
    np.testing.assert_array_equal(scene.tri_normals_oct.numpy(),
                                  ref.tri_normals_oct.numpy())
    for field in ref.materials._fields:
        np.testing.assert_allclose(getattr(scene.materials, field).numpy(),
                                   getattr(ref.materials, field).numpy())
    for field in ref.lights._fields:
        np.testing.assert_allclose(getattr(scene.lights, field).numpy(),
                                   getattr(ref.lights, field).numpy(),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(cam.transform.translation.numpy(),
                               camera_arrays(jcam)["translation"], atol=1e-6)
    np.testing.assert_allclose(cam.inverse_projection.numpy(),
                               camera_arrays(jcam)["inverse_projection"],
                               rtol=1e-6)


@pytest.mark.parametrize("name, n_tris", [
    ("hier_bridge_3k", 3054), ("hier_bridge_15k", 14606),
    ("hier_bridge_50k", 49678), ("torus_grid_28", 258048)])
def test_bridge_scenes_have_the_reference_counts(name, n_tris):
    """bench.py::bench_hier_bridge's three sizes, and the first 28 tori of
    the grid: all over MAX_TRIS, none over the megakernel's cap."""
    scene, cam = port_scenes.TEST_SCENES[name](device="cpu")
    assert int(scene.tri_verts.shape[0]) == n_tris
    assert tpm.MAX_TRIS < n_tris <= tpm.HIER_MAX_TRIS
    assert scene.lights.count == 1
    assert tpm.megakernel_ineligibility_reasons(
        scene, tpt.settings_for_scene(scene)) == []
    eye = (port_scenes.TORUS_GRID_EYE if name == "torus_grid_28"
           else (0.0, 0.6, 2.4))
    np.testing.assert_allclose(cam.transform.translation.numpy(), eye)
