"""The PyTorch port's SmallPT path against the JAX package, on the CPU.

Inputs come from numpy seeds or from the JAX scene carried across as numpy.
The integer chains (Jenkins hash, LCG) are bit-exact. Float results are
compared lane by lane where both sides took the same discrete decisions,
and whole frames under the gate of tests/test_smallpt.py:111-127: fewer
than 2% of the pixels off by more than 1e-4 and means within 2%. The JAX
megakernel runs in interpret mode, as the JAX package's own tests run it.
The plain renderer and the sphere intersection are also held against the
float64 numpy reference ``tests/smallpt_reference.py`` with JAX's own
gates (tests/test_smallpt.py:20-80).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bifrost3d_tpu.integrator import pallas_smallpt as jmega
from bifrost3d_tpu.integrator import smallpt as jspt
from bifrost3d_tpu.integrator import smallvpt as jvpt
from bifrost3d_tpu.sampling import hashes as jhashes
from bifrost3d_tpu.scene import spheres as jspheres

from bifrost3d_tpu_torch.apps import smallpt_app
from bifrost3d_tpu_torch.integrator import pallas_smallpt as tmega
from bifrost3d_tpu_torch.integrator import smallpt as tspt
from bifrost3d_tpu_torch.integrator import smallvpt as tvpt
from bifrost3d_tpu_torch.sampling import hashes as thashes
from bifrost3d_tpu_torch.scene import spheres as tspheres
import smallpt_reference
from torch_parity import (
    assert_float64_reference_gate,
    assert_smallpt_gate,
    sphere_scene_arrays,
)

W, H = 32, 24
LANES_W, LANES_H = 64, 48


@pytest.fixture(scope="module")
def scenes():
    jscene = jspheres.smallpt_scene()
    return jscene, tspheres.sphere_scene_from_numpy(
        sphere_scene_arrays(jscene), device="cpu")


def _uint32_values(seed, n=4096):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, n, dtype=np.uint64)
    x[:4] = (0, 1, 2**31, 2**32 - 1)
    return x


def test_jenkins_hash_is_bit_exact():
    x = _uint32_values(0)
    got = thashes.jenkins_hash(torch.tensor(x.astype(np.int64)))
    ref = jhashes.jenkins_hash(jnp.asarray(x.astype(np.uint32)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), np.asarray(ref))


def test_lcg_next_is_bit_exact():
    x = _uint32_values(1)
    state, u = thashes.lcg_next(torch.tensor(x.astype(np.int64)))
    ref_state, ref_u = jhashes.lcg_next(jnp.asarray(x.astype(np.uint32)))
    np.testing.assert_array_equal(state.numpy().astype(np.uint32),
                                  np.asarray(ref_state))
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(u.numpy().view(np.int32),
                                  np.asarray(ref_u).view(np.int32))


@pytest.mark.parametrize("build", ["smallpt_scene", "smallvpt_scene"])
def test_own_scene_matches_jax_scene(build):
    ref = getattr(jspheres, build)()
    scene = getattr(tspheres, build)(device="cpu")
    for field in ref._fields:
        got = getattr(scene, field).numpy()
        np.testing.assert_array_equal(got, np.asarray(getattr(ref, field)))
        assert got.dtype == (np.int32 if field == "bsdf" else np.float32)


def _rays_in_box(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform((5, 5, 10), (95, 75, 160), size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _abs_cos_at_hit(jscene, o, d, t, idx):
    """|normal . direction| at the hit: a float32 ulp of the 1e5-radius
    walls' coordinates (0.0078) moves t by that over this cosine."""
    pos = o + d * t[:, None]
    n = pos - np.asarray(jscene.position)[idx]
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return np.abs((n * d).sum(-1))


def test_intersect_spheres_matches_jax(scenes):
    jscene, scene = scenes
    # 2,048 rays x 9 spheres stays below torch's parallel grain size, so
    # every elementwise kernel runs on one thread.
    o, d = _rays_in_box(2048, 2)
    t, idx, hit = tspheres.intersect_spheres(scene, torch.tensor(o),
                                             torch.tensor(d))
    rt, ridx, rhit = jspheres.intersect_spheres(jscene, jnp.asarray(o),
                                                jnp.asarray(d))
    assert idx.dtype == torch.int32
    same = idx.numpy() == np.asarray(ridx)
    assert same.mean() >= 0.999
    np.testing.assert_array_equal(hit.numpy()[same], np.asarray(rhit)[same])
    assert hit.all()        # the room is closed
    # b - sqrt(det) cancels at the 1e5-radius walls: the two frameworks'
    # sums differ by a few ulps of 1e5, more along a grazing ray.
    rt, ridx = np.asarray(rt), np.asarray(ridx)
    budget = 0.05 / np.maximum(_abs_cos_at_hit(jscene, o, d, rt, ridx), 1e-3)
    err = np.abs(t.numpy() - rt)
    assert (err[same] <= 1e-5 * rt[same] + budget[same]).all(), err.max()
    assert np.median(err[same]) < 1e-3


def test_intersect_spheres_reports_misses(scenes):
    _, scene = scenes
    ball = tspheres.SphereScene(*(f[6:7] for f in scene))   # the mirror ball
    o = torch.tensor([[27.0, 16.5, 200.0], [27.0, 60.0, 200.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    t, idx, hit = tspheres.intersect_spheres(ball, o, d)
    assert hit.tolist() == [True, False] and idx.tolist() == [0, -1]
    assert abs(float(t[0]) - (200.0 - 47.0 - 16.5)) < 1e-3
    assert torch.isinf(t[1])


def test_intersect_spheres_matches_float64_reference():
    """tests/test_smallpt.py:31-45 for the port: the same sphere hit and
    float32 distances near the float64 reference's."""
    scene = tspheres.smallpt_scene(device="cpu")
    rng = np.random.default_rng(0)
    o = np.asarray([50, 52, 295.6]) + rng.normal(size=(256, 3)) * 5
    d = rng.normal(size=(256, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t64, i64, h64 = smallpt_reference.intersect(o, d)
    t32, i32, h32 = tspheres.intersect_spheres(
        scene, torch.tensor(o, dtype=torch.float32),
        torch.tensor(d, dtype=torch.float32))
    np.testing.assert_array_equal(h32.numpy(), h64)
    np.testing.assert_array_equal(i32.numpy()[h64], i64[h64])
    np.testing.assert_allclose(t32.numpy()[h64], t64[h64], rtol=1e-4,
                               atol=2e-2)


@pytest.fixture(scope="module")
def float64_images():
    """tests/test_smallpt.py's size and accumulations: 64 x 48 x 32."""
    scene = tspheres.smallpt_scene(device="cpu")
    return (tspt.render_smallpt(scene, 64, 48, 32).numpy(),
            smallpt_reference.render(64, 48, 32))


def test_render_smallpt_matches_float64_reference(float64_images):
    """Relative RMS < 0.20 and > 80% of the pixels within 2%."""
    ours, theirs = float64_images
    assert_float64_reference_gate(ours, theirs)


def test_render_smallpt_mean_matches_float64_reference(float64_images):
    ours, theirs = float64_images
    np.testing.assert_allclose(ours.astype(np.float64).mean(), theirs.mean(),
                               rtol=0.03)


def test_camera_ray_matches_jax():
    rng = np.random.default_rng(3)
    u = rng.uniform(size=2048).astype(np.float32)
    v = rng.uniform(size=2048).astype(np.float32)
    o, d = tspt.smallpt_camera_ray(torch.tensor(u), torch.tensor(v), 1024, 768)
    ro, rd = jspt.smallpt_camera_ray(jnp.asarray(u), jnp.asarray(v), 1024, 768)
    np.testing.assert_allclose(o.numpy(), np.asarray(ro), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=1e-5, atol=1e-5)


def _jax_state(accumulation, bounces):
    """The JAX lane state of a 64 x 48 frame after ``bounces`` bounces."""
    x = jnp.broadcast_to(jnp.arange(LANES_W, dtype=jnp.uint32)[None, :],
                         (LANES_H, LANES_W))
    y = jnp.broadcast_to(jnp.arange(LANES_H, dtype=jnp.uint32)[:, None],
                         (LANES_H, LANES_W))
    state = jspt._initial_lane_state(x, y, LANES_W, LANES_H,
                                     jnp.uint32(accumulation))
    scene = jspheres.smallpt_scene()
    step = jax.jit(lambda s, depth: jspt._bounce(scene, s, depth))
    for depth in range(bounces):
        state = step(state, depth)
    return state, step


def test_initial_lane_state_matches_jax():
    ref, _ = _jax_state(3, 0)
    x, y = tspt.pixel_grid(LANES_W, LANES_H, "cpu")
    got = tspt._initial_lane_state(x, y, LANES_W, LANES_H, 3)
    np.testing.assert_array_equal(got[4].numpy().astype(np.uint32),
                                  np.asarray(ref[4]))
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(ref[5]))
    for k in range(4):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bounces", [1, 6])
def test_bounce_matches_jax(scenes, bounces):
    """Bounce number ``bounces`` (the sixth is the first under Russian
    roulette) applied by both packages to the same input state."""
    _, scene = scenes
    before, step = _jax_state(2, bounces - 1)
    ref = [np.asarray(a) for a in step(before, bounces - 1)]
    state = tuple(torch.tensor(np.asarray(a).astype(np.int64))
                  if np.asarray(a).dtype == np.uint32
                  else torch.tensor(np.asarray(a)) for a in before)
    got = [a.numpy() for a in tspt._bounce(scene, state, bounces - 1)]
    o, d, thr, rad, rng, live = got
    ro, rd, rthr, rrad, rrng, rlive = ref
    # Lanes that took the same discrete decisions: the same sphere hit, the
    # same draws consumed, the same survival, the same lobe (a glass pick
    # flips the direction).
    idx = tspheres.intersect_spheres(scene, state[0], state[1])[1].numpy()
    ridx = np.asarray(jspheres.intersect_spheres(
        jspheres.smallpt_scene(), before[0], before[1])[1])
    same = ((idx == ridx) & (rng.astype(np.uint32) == rrng) & (live == rlive)
            & (np.abs(d - rd).max(-1) < 1e-2))
    assert same.mean() >= 0.999
    assert live.sum() > live.size // 4
    for a, b in ((d, rd), (thr, rthr), (rad, rrad)):
        np.testing.assert_allclose(a[same], b[same], rtol=1e-5, atol=1e-5)
    # Hit positions on the 1e5-radius walls differ by a few float32 ulps of
    # 1e5 (0.0078 each), the error ORIGIN_OFFSET = 0.05 exists to absorb;
    # a grazing ray stretches it along its direction, so those are left out.
    before_o, before_d = np.asarray(before[0]), np.asarray(before[1])
    t_in = np.asarray(jspheres.intersect_spheres(
        jspheres.smallpt_scene(), before[0], before[1])[0])
    steep = _abs_cos_at_hit(jspheres.smallpt_scene(),
                            before_o.reshape(-1, 3), before_d.reshape(-1, 3),
                            t_in.reshape(-1), ridx.reshape(-1)) > 0.25
    firm = same & live & steep.reshape(same.shape)
    assert firm.sum() > live.sum() // 2
    np.testing.assert_allclose(o[firm], ro[firm], rtol=1e-5, atol=0.1)


@pytest.fixture(scope="module")
def frames(scenes):
    jscene, scene = scenes
    return {acc: (np.asarray(jspt.render_smallpt_accumulation(
                      jscene, W, H, jnp.uint32(acc))),
                  tspt.render_smallpt_accumulation(scene, W, H, acc).numpy())
            for acc in (1, 2, 3)}


@pytest.mark.parametrize("acc", [1, 2, 3])
def test_accumulation_matches_jax(frames, acc):
    """Per frame only the flip share: at 768 pixels one flipped path that
    reaches the light moves the mean by over 1%."""
    ref, got = frames[acc]
    assert got.shape == (H, W, 3)
    assert_smallpt_gate(got, ref, mean_budget=None)


def test_accumulations_mean_matches_jax(frames):
    ref = np.mean([frames[a][0] for a in (1, 2, 3)])
    got = np.mean([frames[a][1] for a in (1, 2, 3)])
    np.testing.assert_allclose(got, ref, rtol=0.02)


@pytest.mark.parametrize("pool_size", [256, 131072])
def test_pooled_matches_accumulation(scenes, frames, pool_size):
    _, scene = scenes
    pooled, rays = tspt.render_smallpt_pooled_counted(scene, W, H, 2,
                                                      pool_size=pool_size)
    assert_smallpt_gate(pooled.reshape(H, W, 3).numpy(), frames[2][1])
    assert W * H < int(rays) < W * H * tspt.MAX_DEPTH


def test_pooled_matches_jax_pooled(scenes, frames):
    jscene, scene = scenes
    ref = np.asarray(jspt.render_smallpt_pooled(jscene, W, H, jnp.uint32(1),
                                                pool_size=256))
    got = tspt.render_smallpt_pooled(scene, W, H, 1, pool_size=256).numpy()
    assert_smallpt_gate(got, ref, mean_budget=None)


def test_plain_megakernel_matches_jax_megakernel(scenes):
    """The port's plain version of the kernel (what a CPU scene runs)
    against the Pallas kernel in interpret mode."""
    jscene, scene = scenes
    ref = np.asarray(jmega.render_smallpt_megakernel(
        jscene, W, H, jnp.uint32(1), interpret=True))
    before = tmega.launch_count
    got = tmega.render_smallpt_megakernel(scene, W, H, 1).numpy()
    assert tmega.launch_count == before     # no kernel ran on the CPU
    assert_smallpt_gate(got, ref)


def test_render_smallpt_is_the_running_mean(scenes, frames):
    _, scene = scenes
    got = tspt.render_smallpt(scene, W, H, 3).numpy()
    ref = np.mean([frames[a][1] for a in (1, 2, 3)], axis=0)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("acc", [1, 2])
def test_smallvpt_matches_jax(acc):
    ref = np.asarray(jvpt.render_smallvpt_accumulation(
        jspheres.smallvpt_scene(), W, H, jnp.uint32(acc)))
    got = tvpt.render_smallvpt_accumulation(
        tspheres.smallvpt_scene(device="cpu"), W, H, acc).numpy()
    assert_smallpt_gate(got, ref)
    assert got.mean() > 0.01


@pytest.mark.parametrize("volumetric", [False, True])
def test_app_writes_a_png(tmp_path, capsys, volumetric):
    out = tmp_path / "frame.png"
    args = ["--device", "cpu", "--width", "32", "--height", "24", "-n", "2",
            "-o", str(out)] + (["--volumetric"] if volumetric else [])
    assert smallpt_app.main(args) == 0
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert int.from_bytes(data[16:20], "big") == 32      # IHDR width
    assert int.from_bytes(data[20:24], "big") == 24      # IHDR height
    assert "on cpu" in capsys.readouterr().out


def test_app_defaults_to_cuda_and_flips_rows():
    import inspect
    assert inspect.signature(
        smallpt_app.render_progressive).parameters["device"].default == "cuda"
    img = smallpt_app.render_progressive(W, H, 8, quiet=True, device="cpu")
    # Row 0 is the bottom: the ceiling light is in the last rows.
    assert float(img[-3:, W // 3:2 * W // 3].mean()) > float(img.mean())


def test_dispatch_by_device(scenes):
    _, scene = scenes
    meta = tspheres.SphereScene(*(f.to("meta") for f in scene))
    with pytest.raises(ValueError, match="meta"):
        tmega.render_smallpt_megakernel(meta, 8, 8, 1)
    with pytest.raises(ValueError, match="CUDA"):
        tmega.smallpt_megakernel_cuda(scene, 8, 8, 1)


def test_sphere_table_layout(scenes):
    _, scene = scenes
    sph, bsdf = tmega.sphere_table(scene)
    assert sph.shape == (9, 10) and sph.dtype == torch.float32
    assert bsdf.dtype == torch.int32 and bsdf.tolist() == [0] * 6 + [1, 2, 0]
    np.testing.assert_array_equal(sph[8].numpy(), np.asarray(
        [50, 681.6 - 0.27, 81.6, 600, 12, 12, 12, 0, 0, 0], np.float32))
