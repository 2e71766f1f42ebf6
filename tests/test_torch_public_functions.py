"""The public functions the port's modules had left out, against JAX.

Transforms, quaternions, vectors, colours, the sampling distributions and
the tonemapper are float math, gated by
``torch_parity.assert_f64_anchored``; hashes and Sobol are bit for bit;
mesh creation and mesh utilities are host numpy and must match array for
array; the material presets, the orthographic projection, the light and
BSDF-sample helpers are equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bifrost3d_tpu.bsdf import types as jbt
from bifrost3d_tpu.geometry import creation as jcr
from bifrost3d_tpu.geometry import mesh as jmesh
from bifrost3d_tpu.lights import analytic as jan
from bifrost3d_tpu.lights.types import LightArray as JLightArray
from bifrost3d_tpu.math import color as jcol
from bifrost3d_tpu.math import quaternion as jq
from bifrost3d_tpu.math import transform as jtr
from bifrost3d_tpu.math import vec as jvec
from bifrost3d_tpu.post import tonemap as jtm
from bifrost3d_tpu.sampling import distributions as jd
from bifrost3d_tpu.sampling import hashes as jh
from bifrost3d_tpu.scene import camera as jcam
from bifrost3d_tpu.scene import materials as jmat

from bifrost3d_tpu_torch.bsdf import types as tbt
from bifrost3d_tpu_torch.geometry import creation as tcr
from bifrost3d_tpu_torch.geometry import mesh as tmesh
from bifrost3d_tpu_torch.lights import analytic as tan
from bifrost3d_tpu_torch.lights.types import LightArray
from bifrost3d_tpu_torch.math import color as tcol
from bifrost3d_tpu_torch.math import quaternion as tq
from bifrost3d_tpu_torch.math import transform as ttr
from bifrost3d_tpu_torch.math import vec as tvec
from bifrost3d_tpu_torch.post import tonemap as ttm
from bifrost3d_tpu_torch.sampling import distributions as td
from bifrost3d_tpu_torch.sampling import hashes as th
from bifrost3d_tpu_torch.scene import camera as tcam
from bifrost3d_tpu_torch.scene import materials as tmat
from torch_parity import assert_f64_anchored

N = 2048
rng = np.random.default_rng(14)


def _unit_quats(n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _transform_args(n):
    return (rng.uniform(-4, 4, (n, 3)).astype(np.float32), _unit_quats(n),
            rng.uniform(0.25, 3.0, n).astype(np.float32))


def test_identities_equal_jax():
    for port, ref in zip(ttr.transform_identity(), jtr.transform_identity()):
        assert port.dtype == torch.float32 and port.device.type == "cpu"
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tq.quat_identity().numpy(),
                                  np.asarray(jq.quat_identity()))


def test_transform_compose_and_delta_anchored():
    def run(mod):
        def fn(t1, r1, s1, t2, r2, s2):
            a = mod.Transform(t1, r1, s1)
            b = mod.Transform(t2, r2, s2)
            return mod.transform_compose(a, b), mod.transform_delta(a, b)
        return fn
    assert_f64_anchored(run(ttr), run(jtr), *_transform_args(N),
                        *_transform_args(N))


def test_quat_mul_anchored():
    assert_f64_anchored(tq.quat_mul, jq.quat_mul, _unit_quats(N),
                        _unit_quats(N))


def test_vec3_and_distance():
    x = rng.normal(size=(N,)).astype(np.float32)
    port = tvec.vec3(torch.tensor(x), 2.0, torch.tensor(x[:1]))
    np.testing.assert_array_equal(port.numpy(),
                                  np.asarray(jvec.vec3(x, 2.0, x[:1])))
    assert port.dtype == torch.float32
    a = rng.normal(size=(N, 3)).astype(np.float32)
    b = rng.normal(size=(N, 3)).astype(np.float32)
    assert_f64_anchored(tvec.distance, jvec.distance, a, b)


def test_hsv_round_trip_anchored():
    rgb = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    rgb[:8] = rgb[:8, :1]            # greys: no hue
    rgb[8] = 0.0
    rgb[9:12] = np.eye(3)            # each primary is the maximum
    assert_f64_anchored(tcol.rgb_to_hsv, jcol.rgb_to_hsv, rgb)
    hsv = np.stack([rng.uniform(0, 360, N), rng.uniform(0, 1, N),
                    rng.uniform(0, 2, N)], -1).astype(np.float32)
    assert_f64_anchored(tcol.hsv_to_rgb, jcol.hsv_to_rgb, hsv)


def test_is_delta_light_equals_jax():
    dicts = [dict(kind=0, position=(0, 1, 0), radius=0.0, power=(1, 1, 1)),
             dict(kind=0, position=(1, 2, 0), radius=0.3, power=(1, 1, 1)),
             dict(kind=1, position=(0, 2, 1), radius=0.0, power=(1, 1, 1),
                  direction=(0, -1, 0), cos_angle=0.5),
             dict(kind=1, position=(0, 2, 1), radius=0.2, power=(1, 1, 1),
                  direction=(0, -1, 0), cos_angle=0.5),
             dict(kind=2, radiance=(2, 2, 2), direction=(0, -1, 0))]
    index = rng.integers(0, len(dicts), N).astype(np.int32)
    lit = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    port = tan.is_delta_light(LightArray.build(dicts, device="cpu"),
                              torch.tensor(index).long(), torch.tensor(lit))
    ref = jan.is_delta_light(JLightArray.build(dicts), jnp.asarray(index),
                             jnp.asarray(lit))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    assert 0 < int(port.sum()) < N


def test_material_presets_equal_jax():
    assert tmat.emissive((4, 4, 2), roughness=0.3) == \
        jmat.emissive((4, 4, 2), roughness=0.3)
    for args in (((0.5, 0.2, 0.1), 0.4), ((1, 1, 1), 0.1, 0.08, 0.2)):
        assert tmat.coated_dielectric(*args, flags=1) == \
            jmat.coated_dielectric(*args, flags=1)


def test_orthographic_projection_equals_jax():
    for proj, ref in zip(tcam.orthographic_projection(4.0, 3.0, 10.0,
                                                      device="cpu"),
                         jcam.orthographic_projection(4.0, 3.0, 10.0)):
        np.testing.assert_array_equal(proj.numpy(), np.asarray(ref))


def _assert_meshes_equal(port, ref):
    for name in type(port)._fields:
        a, b = getattr(port, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert np.asarray(a).dtype == np.asarray(b).dtype, name
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=name)


@pytest.mark.parametrize("make, kwargs", [
    ("make_cylinder", {}),
    ("make_cylinder", dict(radius=0.3, height=2.0, slices=12, stacks=3)),
    ("make_beveled_box", {}),
    ("make_beveled_box", dict(size=(1.0, 0.5, 2.0), bevel=0.4, segments=2)),
    ("make_spherical_box", {}),
    ("make_spherical_box", dict(radius=1.5, segments=3)),
])
def test_creation_matches_jax(make, kwargs):
    _assert_meshes_equal(getattr(tcr, make)(**kwargs),
                         getattr(jcr, make)(**kwargs))


def _mesh_pair(mesh):
    """A port mesh and the JAX package's from the same numpy buffers."""
    return mesh, jmesh.TriangleMesh(
        indices=jnp.asarray(mesh.indices),
        positions=jnp.asarray(mesh.positions),
        normals=None if mesh.normals is None else jnp.asarray(mesh.normals),
        texcoords=(None if mesh.texcoords is None
                   else jnp.asarray(mesh.texcoords)))


@pytest.mark.parametrize("which", ["sphere", "box", "welded", "degenerate"])
def test_mesh_utilities_match_jax(which):
    if which == "sphere":
        mesh = tcr.make_sphere(radius=0.7, slices=9, stacks=5)
    elif which == "box":
        mesh = tcr.make_box(size=(1.0, 2.0, 0.5), segments=2)
    elif which == "welded":
        mesh = tmesh.expand_indexed_buffers(tcr.make_torus(1.0, 0.3, 8, 6))
    else:
        mesh = tcr.make_plane(size=2.0, segments=3)
        idx = mesh.indices.copy()
        idx[0, 1] = idx[0, 0]                       # a repeated index
        mesh = mesh._replace(indices=np.concatenate([idx, [[0, 1, 2]]]))
        mesh = mesh._replace(normals=-mesh.normals)  # against the winding
    port, ref = _mesh_pair(mesh)
    _assert_meshes_equal(tmesh.compute_hard_normals(port),
                         jmesh.compute_hard_normals(ref))
    _assert_meshes_equal(tmesh.expand_indexed_buffers(port),
                         jmesh.expand_indexed_buffers(ref))
    for tol in (0.0, 1e-3):
        _assert_meshes_equal(tmesh.merge_duplicate_vertices(port, tol),
                             jmesh.merge_duplicate_vertices(ref, tol))
    assert tmesh.normals_correspond_to_winding_order(port) == \
        jmesh.normals_correspond_to_winding_order(ref)
    for eps in (1e-10, 1e-2):
        assert tmesh.count_degenerate_primitives(port, eps) == \
            jmesh.count_degenerate_primitives(ref, eps)


def test_uniform_sphere_sample_anchored():
    u2 = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    u2[:4] = [[0.5, 0.5], [0.0, 0.0], [1.0, 0.5], [0.5, 1.0]]
    # The pdf is a constant: JAX keeps it float32 in its float64 run, so
    # the directions are anchored and the float32 pdfs compared.
    assert_f64_anchored(lambda u: td.uniform_sphere_sample(u)[0],
                        lambda u: jd.uniform_sphere_sample(u)[0], u2)
    np.testing.assert_array_equal(
        td.uniform_sphere_sample(torch.tensor(u2))[1].numpy(),
        np.asarray(jd.uniform_sphere_sample(jnp.asarray(u2))[1]))


def test_ggx_ndf_sample_and_pdf_anchored():
    alpha = rng.uniform(0.02, 1.0, N).astype(np.float32)
    u2 = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    cos = rng.uniform(0.01, 1.0, N).astype(np.float32)
    assert_f64_anchored(td.ggx_ndf_sample, jd.ggx_ndf_sample, alpha, u2)
    assert_f64_anchored(td.ggx_ndf_pdf, jd.ggx_ndf_pdf, alpha, cos)


def test_exponential_distance_sample_anchored():
    sigma = rng.uniform(0.1, 8.0, N).astype(np.float32)
    u = rng.uniform(0, 1, N).astype(np.float32)
    assert_f64_anchored(td.exponential_distance_sample,
                        jd.exponential_distance_sample, sigma, u)


def test_hashes_bit_exact():
    a = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    c = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    a[:4] = (0, 1, 0xFFFFFFFF, 0x80000000)
    ta, tb, tc = (torch.tensor(x.astype(np.int64)) for x in (a, b, c))
    ja, jb, jc = (jnp.asarray(x) for x in (a, b, c))

    def same(port, ref):
        port, ref = port.numpy(), np.asarray(ref)
        if ref.dtype == np.float32:
            assert port.dtype == np.float32
            np.testing.assert_array_equal(port.view(np.uint32),
                                          ref.view(np.uint32))
        else:
            np.testing.assert_array_equal(port.astype(np.uint32), ref)

    same(th.van_der_corput(ta, tb), jh.van_der_corput(ja, jb))
    same(th.sobol2(ta, tb), jh.sobol2(ja, jb))
    same(th.sobol2(torch.arange(64), 0), jh.sobol2(jnp.arange(64), 0))
    same(th.teschner_hash(ta, tb), jh.teschner_hash(ja, jb))
    same(th.teschner_hash(ta, tb, tc), jh.teschner_hash(ja, jb, jc))
    same(th.laine_karras_hash(ta, tb), jh.laine_karras_hash(ja, jb))


def test_invalidate_equals_jax():
    d = rng.normal(size=(N, 3)).astype(np.float32)
    pdf = rng.uniform(0, 2, N).astype(np.float32)
    delta = rng.integers(0, 2, N).astype(bool)
    f = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    bad = rng.integers(0, 2, N).astype(bool)
    port = tbt.invalidate(tbt.BSDFSample(*(torch.tensor(x) for x in
                                           (d, pdf, delta, f))),
                          torch.tensor(bad))
    ref = jbt.invalidate(jbt.BSDFSample(*(jnp.asarray(x) for x in
                                          (d, pdf, delta, f))),
                         jnp.asarray(bad))
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_reinhard_anchored():
    color = np.exp(rng.normal(-0.5, 1.5, (N, 3))).astype(np.float32)
    color[0] = 0.0
    assert_f64_anchored(ttm.reinhard, jtm.reinhard, color)
    assert_f64_anchored(lambda c: ttm.reinhard(c, 4.0),
                        lambda c: jtm.reinhard(c, 4.0), color)
