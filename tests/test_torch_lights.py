"""The port's analytic lights and math helpers against the JAX package.

float32 allclose at rtol 1e-5, atol 1e-6 (with the ill-conditioned-lane
allowance of ``torch_parity.assert_close_f32``); octahedral codes, the
ray-origin offset and delta flags are exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bifrost3d_tpu.integrator import path_tracer as jpt
from bifrost3d_tpu.lights import analytic as jla
from bifrost3d_tpu.lights.types import LightArray as JLights
from bifrost3d_tpu.math import octahedral as joct
from bifrost3d_tpu.math import quaternion as jq
from bifrost3d_tpu.math import ray_offset as jro
from bifrost3d_tpu.math import vec as jvec
from bifrost3d_tpu.scene import camera as jcam

from bifrost3d_tpu_torch.integrator import path_tracer as tpt
from bifrost3d_tpu_torch.lights import analytic as tla
from bifrost3d_tpu_torch.lights.types import LightArray as TLights
from bifrost3d_tpu_torch.math import octahedral as toct
from bifrost3d_tpu_torch.math import quaternion as tq
from bifrost3d_tpu_torch.math import ray_offset as tro
from bifrost3d_tpu_torch.math import vec as tvec
from bifrost3d_tpu_torch.scene import camera as tcam
from torch_parity import assert_close_f32, assert_f64_anchored, camera_arrays

N = 2048
LIGHTS = [
    {"kind": 0, "position": (0.0, 0.45, 0.0), "radius": 0.05,
     "power": (2.0, 2.0, 2.0)},
    {"kind": 1, "position": (0.3, 0.4, 0.1), "radius": 0.1,
     "direction": (0.1, -1.0, 0.2), "cos_angle": 0.6, "power": (3.0, 2.0, 1.0)},
    {"kind": 1, "position": (-0.3, 0.4, 0.1), "radius": 0.0,
     "direction": (0.0, -1.0, 0.0), "cos_angle": 0.8, "power": (1.0, 1.0, 1.0)},
    {"kind": 2, "direction": (0.3, -1.0, 0.2), "radiance": (0.5, 0.6, 0.7)},
]


def _close(got, ref):
    if isinstance(got, tuple):
        for g, r in zip(got, ref):
            _close(g, r)
        return
    got, ref = got.numpy(), np.asarray(ref)
    if got.dtype == np.bool_ or np.issubdtype(got.dtype, np.integer):
        np.testing.assert_array_equal(got, ref)
    else:
        assert_close_f32(got, ref)


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(9)
    pos = rng.uniform(-0.5, 0.3, size=(N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    u2 = rng.uniform(0, 1, size=(N, 2)).astype(np.float32)
    index = (np.arange(N) % len(LIGHTS)).astype(np.int32)
    return pos, d, u2, index


def test_light_sample_pdf_evaluate(lanes):
    """Gate ``torch_parity.assert_f64_anchored`` over the four lights'
    arrays (built once in float32 by JAX, carried to both sides): the
    sphere light's pdf cancels in ``1 - sqrt(1 - r²/d²)`` in both
    packages."""
    pos, d, u2, index = lanes
    fields = {k: np.asarray(v) for k, v in JLights.build(LIGHTS)._asdict().items()}
    for k, v in TLights.build(LIGHTS, device="cpu")._asdict().items():
        np.testing.assert_array_equal(v.numpy(), fields[k], err_msg=k)

    def port(fn):
        return lambda f, *a: fn(TLights(**f), *a)

    def ref(fn):
        return lambda f, *a: fn(JLights(**f), *a)
    assert_f64_anchored(port(lambda l, i, p, u: tuple(tla.sample_light(l, i, p, u))),
                        ref(lambda l, i, p, u: tuple(jla.sample_light(l, i, p, u))),
                        fields, index, pos, u2)
    assert_f64_anchored(port(tla.light_pdf), ref(jla.light_pdf),
                        fields, index, pos, d)
    assert_f64_anchored(port(tla.evaluate_light), ref(jla.evaluate_light),
                        fields, index, pos, d)


def test_analytic_light_hits(lanes):
    pos, d, _, _ = lanes
    tl, jl = TLights.build(LIGHTS, device="cpu"), JLights.build(LIGHTS)
    t_scene = type("S", (), {"lights": tl})
    j_scene = type("S", (), {"lights": jl})
    got = tpt._intersect_analytic_lights(t_scene, torch.tensor(pos),
                                         torch.tensor(d))
    ref = jpt._intersect_analytic_lights(j_scene, jnp.asarray(pos),
                                         jnp.asarray(d))
    _close(got, ref)
    assert int((got[1] >= 0).sum()) > 0


def test_mis_weight():
    rng = np.random.default_rng(10)
    a = rng.uniform(0, 5, size=N).astype(np.float32)
    b = rng.uniform(0, 5, size=N).astype(np.float32)
    a[:3], b[:3] = (0.0, np.inf, 0.0), (0.0, 1.0, np.inf)
    _close(tpt.mis_weight(torch.tensor(a), torch.tensor(b)),
           jpt.mis_weight(jnp.asarray(a), jnp.asarray(b)))


def test_ris_offsets_match():
    np.testing.assert_array_equal(tpt._reverse_halton_offsets(8),
                                  jpt._RIS_OFFSETS)


def test_octahedral_encode_decode():
    rng = np.random.default_rng(11)
    n = rng.normal(size=(N, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    code = toct.octahedral_encode(torch.tensor(n))
    np.testing.assert_array_equal(code.numpy(),
                                  np.asarray(joct.octahedral_encode(n)))
    _close(toct.octahedral_decode(code),
           joct.octahedral_decode(jnp.asarray(code.numpy())))


def test_offset_ray_origin_exact():
    rng = np.random.default_rng(12)
    p = rng.normal(scale=2.0, size=(N, 3)).astype(np.float32)
    p[:16] *= 1e-3                      # near-origin branch
    n = rng.normal(size=(N, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    np.testing.assert_array_equal(
        tro.offset_ray_origin(torch.tensor(p), torch.tensor(n)).numpy(),
        np.asarray(jro.offset_ray_origin(jnp.asarray(p), jnp.asarray(n))))


def test_tangent_frames_and_quaternions():
    rng = np.random.default_rng(13)
    n = rng.normal(size=(N, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    v = rng.normal(size=(N, 3)).astype(np.float32)
    _close(tvec.to_local(torch.tensor(v), torch.tensor(n)),
           jvec.to_local(jnp.asarray(v), jnp.asarray(n)))
    _close(tvec.to_world(torch.tensor(v), torch.tensor(n)),
           jvec.to_world(jnp.asarray(v), jnp.asarray(n)))
    q = torch.tensor(np.asarray(jq.quat_from_axis_angle(
        jnp.asarray([0.0, 1.0, 0.0]), 0.7)))
    _close(tq.quat_rotate(q, torch.tensor(v)),
           jq.quat_rotate(jnp.asarray(q.numpy()), jnp.asarray(v)))
    m = jq.quat_to_matrix(jnp.asarray(q.numpy()))
    _close(tq.quat_from_matrix(torch.tensor(np.asarray(m))),
           jq.quat_from_matrix(m))


def test_camera_rays():
    jc = jcam.perspective_camera(eye=(0.3, 0.1, -1.5), target=(0, 0, 0),
                                 fov_radians=0.8, aspect=1.5)
    tc = tcam.perspective_camera(eye=(0.3, 0.1, -1.5), target=(0, 0, 0),
                                 fov_radians=0.8, aspect=1.5, device="cpu")
    for name, value in camera_arrays(jc).items():
        got = (getattr(tc.transform, name).numpy() if hasattr(tc.transform, name)
               else getattr(tc, name).numpy())
        np.testing.assert_allclose(got, value, rtol=1e-6, atol=1e-6)
    vp = np.random.default_rng(14).uniform(0, 1, size=(N, 2)).astype(np.float32)
    carried = tcam.camera_from_numpy(camera_arrays(jc), device="cpu")
    _close(tcam.camera_ray_directions(carried, torch.tensor(vp)),
           jcam.camera_ray_directions(jc, jnp.asarray(vp)))
