"""The port's gradients against the JAX package's, on the CPU:
``offset_ray_origin``'s rule, ``render_loss_grad``'s cotangent of every
float leaf of the scene, and finite SmallPT gradients.

The scene and settings are those of tests/test_diff.py:17-35 (a dielectric
sphere under a sphere light and a constant environment, 16 × 12,
2 bounces, the Default model only, one RIS candidate), built by the JAX
package and carried across with ``render_scene_from_numpy``. Both sides
run the same estimator on the same hits, so the gradients agree to
float32 reassociation: each leaf within rtol 1e-4, atol 1e-8 (measured:
at most 4e-5 relative on entries above a thousandth of the leaf's largest,
at most 3e-9 absolute elsewhere), with the port's elementary functions
rounded once from float64 (``torch_parity.elementary_rounded_once``).
With the host's own (torch's float32 ``sqrt`` on an AVX-512 CPU is
faithful, not correctly rounded) the light radius's cotangent moves by
3.35e-4 relative: it comes through the sphere light's cancelling
``1 - sqrt(1 - r²/d²)``. That leaf is held at rtol 1e-3 in the host run,
every other at rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifrost3d_tpu.diff import render_loss_grad as jax_render_loss_grad
from bifrost3d_tpu.geometry import make_sphere
from bifrost3d_tpu.integrator import path_tracer as jpt
from bifrost3d_tpu.lights.types import LIGHT_SPHERE
from bifrost3d_tpu.lights.types import LightArray as JaxLightArray
from bifrost3d_tpu.math.ray_offset import offset_ray_origin as jax_offset
from bifrost3d_tpu.scene.camera import perspective_camera as jax_camera
from bifrost3d_tpu.scene.materials import MaterialArray as JaxMaterialArray
from bifrost3d_tpu.scene.materials import dielectric as jax_dielectric
from bifrost3d_tpu.scene.render_scene import build_render_scene

from bifrost3d_tpu_torch.diff import render_loss_grad
from bifrost3d_tpu_torch.integrator import path_tracer as tpt
from bifrost3d_tpu_torch.integrator.smallpt import render_smallpt_accumulation
from bifrost3d_tpu_torch.math.ray_offset import offset_ray_origin
from bifrost3d_tpu_torch.scene.camera import camera_from_numpy
from bifrost3d_tpu_torch.scene.render_scene import render_scene_from_numpy
from bifrost3d_tpu_torch.scene.spheres import smallpt_scene
from torch_parity import camera_arrays, elementary_rounded_once, scene_arrays

W, H = 16, 12
SETTINGS = jpt.RenderSettings(max_bounce_count=2, shading_models_present=(0,),
                              next_event_sample_count=1)


def make_jax_scene(tint=(0.6, 0.4, 0.2), roughness=0.6):
    """tests/test_diff.py's make_scene."""
    mats = JaxMaterialArray.build([jax_dielectric(tint, roughness)])
    lights = JaxLightArray.build([
        {"kind": LIGHT_SPHERE, "position": (0, 2.0, 1.0), "radius": 0.2,
         "power": (30, 30, 30)}])
    return build_render_scene(
        [(make_sphere(radius=0.5, slices=24, stacks=12), 0, None)],
        mats, lights, environment_map=np.full((16, 32, 3), 0.2, np.float32))


def make_jax_camera():
    return jax_camera(eye=(0, 0.5, 2.2), target=(0, 0, 0))


# -- offset_ray_origin ---------------------------------------------------------------

# One point per branch: |p| >= 1/32 takes the integer nudge, |p| < 1/32 the
# float offset.
OFFSET_CASES = {"integer": ([1.0, -2.0, 0.5], [0.3, -0.8, 0.5]),
                "float": ([0.01, -0.02, 0.005], [0.6, 0.0, -0.8]),
                "mixed": ([1.0, -2.0, 0.01], [0.0, 1.0, 0.0])}


@pytest.mark.parametrize("case", sorted(OFFSET_CASES))
def test_offset_ray_origin_gradient_matches_jax(case):
    """The forward bit for bit, and the rule of JAX's custom JVP: the
    position tangent passes through, the normal's is dropped, on both
    branches. Before the rule was ported, the integer branch's bit cast
    cut the position's gradient to zero."""
    p_np, n_np = (np.asarray(a, np.float32) for a in OFFSET_CASES[case])
    cot = np.asarray([0.7, -1.3, 2.1], np.float32)
    out, vjp = jax.vjp(jax_offset, jnp.asarray(p_np), jnp.asarray(n_np))
    jax_gp, jax_gn = (np.asarray(g) for g in vjp(jnp.asarray(cot)))
    _, jvp_out = jax.jvp(jax_offset, (jnp.asarray(p_np), jnp.asarray(n_np)),
                         (jnp.asarray(cot), jnp.ones(3)))

    p = torch.tensor(p_np, requires_grad=True)
    n = torch.tensor(n_np, requires_grad=True)
    got = offset_ray_origin(p, n)
    np.testing.assert_array_equal(got.detach().numpy().view(np.int32),
                                  np.asarray(out).view(np.int32))
    gp, gn = torch.autograd.grad(got, (p, n), torch.tensor(cot),
                                 allow_unused=True, materialize_grads=True)
    np.testing.assert_array_equal(gp.numpy(), jax_gp)
    np.testing.assert_array_equal(gn.numpy(), jax_gn)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(jvp_out))
    np.testing.assert_array_equal(gp.numpy(), cot)


# -- render_loss_grad ----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_loss_grad():
    scene, cam = make_jax_scene(), make_jax_camera()
    loss, grads = jax_render_loss_grad(scene, cam, jnp.zeros((H, W, 3)), W, H,
                                       jnp.uint32(0), SETTINGS)
    return scene, cam, float(loss), grads


def _port_loss_grad(jax_loss_grad):
    scene, cam, _, _ = jax_loss_grad
    port_scene = render_scene_from_numpy(scene_arrays(scene), device="cpu")
    port_cam = camera_from_numpy(camera_arrays(cam), device="cpu")
    loss, grads = render_loss_grad(port_scene, port_cam, torch.zeros(H, W, 3),
                                   W, H, 0, tpt.RenderSettings(*SETTINGS))
    return port_scene, float(loss), grads


@pytest.fixture(scope="module")
def port_loss_grad(jax_loss_grad):
    return _port_loss_grad(jax_loss_grad)


@pytest.fixture(scope="module")
def port_loss_grad_rounded_once(jax_loss_grad):
    with elementary_rounded_once():
        return _port_loss_grad(jax_loss_grad)


def _leaves(tree, path=""):
    """Field path → leaf of a tree of NamedTuples."""
    if tree is None:
        return {}
    if hasattr(tree, "_fields"):
        out = {}
        for name in tree._fields:
            out.update(_leaves(getattr(tree, name), f"{path}.{name}"))
        return out
    return {path: tree}


def test_render_loss_grad_loss_matches_jax(jax_loss_grad, port_loss_grad):
    _, _, jax_loss, _ = jax_loss_grad
    _, loss, _ = port_loss_grad
    assert loss > 0.0
    np.testing.assert_allclose(loss, jax_loss, rtol=1e-5)


# The host run's tolerance per leaf where it is not 1e-4: measured
# host-vs-rounded-once spread 3.35e-4 relative (module docstring).
HOST_RTOL = {".lights.radius": 1e-3}


def _compare(ref, got, rtol):
    compared = []
    for path, want in ref.items():
        want = np.asarray(want)
        if want.dtype == jax.dtypes.float0 or path not in got:
            continue
        have = got[path].numpy()
        assert have.shape == want.shape, path
        np.testing.assert_allclose(have, want, rtol=rtol.get(path, 1e-4),
                                   atol=1e-8, err_msg=path)
        compared.append(path)
    return compared


def test_render_loss_grad_cotangents_match_jax(jax_loss_grad, port_loss_grad,
                                               port_loss_grad_rounded_once):
    """Every float leaf of JAX's cotangent, matched by field path to the
    port's: within rtol 1e-4, atol 1e-8 with the elementary functions
    rounded once, and the host run within ``HOST_RTOL``. The trace tables
    (the dense table, the BVH boxes) and the query epsilon are zero on
    both sides: the queries are detached. The vertex buffer's and the
    light position's gradients need the detached queries and the offset's
    rule."""
    _, _, _, jax_grads = jax_loss_grad
    port_scene, _, grads = port_loss_grad
    ref, got = _leaves(jax_grads), _leaves(grads)
    _compare(ref, _leaves(port_loss_grad_rounded_once[2]), {})
    compared = _compare(ref, got, HOST_RTOL)
    for path in (".tri_verts", ".lights.position", ".lights.power",
                 ".materials.tint", ".materials.roughness",
                 ".environment.image", ".environment.tint"):
        assert path in compared and np.abs(got[path].numpy()).max() > 0, path
    for path in (".tri_components", ".bvh.node_min", ".bvh.node_max",
                 ".scene_epsilon"):
        assert path in compared and not np.any(got[path].numpy()), path
    # Every float leaf of the port's scene has a cotangent, every integer
    # leaf None.
    for path, leaf in _leaves(port_scene).items():
        if isinstance(leaf, torch.Tensor):
            assert (got.get(path) is None) != leaf.is_floating_point(), path


def test_scene_queries_see_no_graph(port_loss_grad):
    """After a gradient over every float leaf, the scene queries' detached
    tables (and the kernels' table cache, used on a card) hold no tensor
    with autograd history."""
    from bifrost3d_tpu_torch.geometry import pallas_intersect
    port_scene, _, _ = port_loss_grad
    aliases = tpt._DETACHED.values()
    assert aliases      # the dense table, the BVH boxes, the epsilon
    for t in aliases + [t for v in pallas_intersect._TABLES.values()
                        for t in v]:
        assert t.grad_fn is None and not t.requires_grad
    scene = port_scene._replace(materials=port_scene.materials._replace(
        tint=port_scene.materials.tint.clone().requires_grad_()))
    cam = camera_from_numpy(camera_arrays(make_jax_camera()), device="cpu")
    # Two backward passes through two frames: no cached graph is shared
    # (a second backward through one would raise).
    for _ in range(2):
        img = tpt.render_sample(scene, cam, 8, 6, 0,
                                tpt.RenderSettings(*SETTINGS))
        img.mean().backward()
    assert torch.isfinite(scene.materials.tint.grad).all()


# -- SmallPT ---------------------------------------------------------------------------

def test_smallpt_gradients_are_finite():
    """tests/test_diff.py:191-208: the SmallPT estimator's pathwise position
    gradient is finite (no masked lane's NaN leaks through a miss's inf t
    or a total internal reflection's square root)."""
    scene = smallpt_scene(device="cpu")
    position = scene.position.clone().requires_grad_()
    img = render_smallpt_accumulation(scene._replace(position=position),
                                      16, 12, 1)
    (g,) = torch.autograd.grad(img.mean(), position)
    assert torch.isfinite(g).all()
    assert float(g.abs().max()) > 0.0
