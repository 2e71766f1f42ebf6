"""Shared helpers for the parity tests of the PyTorch port (test_torch_*.py).

Data crosses between the JAX package and the port as numpy arrays only.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

# pytest-xdist runs several workers on the host's cores, and torch's OpenMP
# pool of one thread per core in each worker oversubscribes them: a small
# frame's many short parallel ops then wait on each other, and a test of a
# few seconds alone took minutes in the full run. One thread per worker.
torch.set_num_threads(1)


def _to_numpy(value):
    """NamedTuples → dicts of numpy arrays; arrays → numpy; None stays."""
    if value is None:
        return None
    if hasattr(value, "_asdict"):
        return {k: _to_numpy(v) for k, v in value._asdict().items()}
    return np.asarray(value)


def scene_arrays(scene) -> dict:
    """A JAX RenderScene as the dict ``render_scene_from_numpy`` takes, its
    BVH included (so both renderers can trace the same tree); the JAX
    packings ``tri_components`` (same layout in the port) and
    ``tri_clustered`` ride along as they are: a ``VmemTriangles`` or a
    ``ClusteredTriangles`` is carried into the port's, so both trace the
    same clusters, and for a ``HierTriangles`` the port packs its own."""
    return {k: _to_numpy(v) for k, v in scene._asdict().items()}


def packing_arrays(packed) -> dict:
    """A JAX ``VmemTriangles`` or ``ClusteredTriangles`` as the dict the
    port's ``from_numpy`` of the same name takes."""
    return _to_numpy(packed)


def sphere_scene_arrays(scene) -> dict:
    """A JAX SphereScene as the dict ``sphere_scene_from_numpy`` takes."""
    return _to_numpy(scene)


def bvh_arrays(bvh) -> dict:
    """A JAX BVH as the dict ``BVH.from_numpy`` takes."""
    return _to_numpy(bvh)


def assert_smallpt_gate(img, ref, flip_budget=0.02, mean_budget=0.02):
    """The SmallPT frame gate of tests/test_smallpt.py:111-127: fewer than
    ``flip_budget`` of the pixels differ by more than 1e-4 (a grazing hit on
    a 1e5-radius wall or a roulette draw that float reassociation flips
    gives a different but equally valid path), and, with a ``mean_budget``,
    the means agree within it."""
    img = np.asarray(img)
    ref = np.asarray(ref)
    assert img.shape == ref.shape
    assert np.isfinite(img).all()
    flips = float((np.abs(img - ref).max(axis=-1) > 1e-4).mean())
    assert flips < flip_budget, flips
    if mean_budget is not None:
        np.testing.assert_allclose(img.mean(), ref.mean(), rtol=mean_budget)
    return flips


def assert_float64_reference_gate(img, ref):
    """The SmallPT image gates of tests/test_smallpt.py:63-80 against the
    float64 numpy reference (``tests/smallpt_reference.py``): relative RMS
    under 0.20, more than 80% of the pixels within 2% (of the reference's
    largest channel plus 1e-2), and the means within 3%. Returns the three
    measures."""
    img = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    assert img.shape == ref.shape
    assert np.isfinite(img).all()
    rel_rms = float(np.sqrt(np.mean((img - ref) ** 2)) / ref.mean())
    assert rel_rms < 0.20, f"relative RMS {rel_rms}"
    rel_err = np.abs(img - ref).max(axis=-1) / (ref.max(axis=-1) + 1e-2)
    within = float(np.mean(rel_err < 0.02))
    assert within > 0.80, within
    np.testing.assert_allclose(img.mean(), ref.mean(), rtol=0.03)
    return dict(rel_rms=rel_rms, within_2pct=within,
                mean=float(img.mean()), ref_mean=float(ref.mean()))


def write_shader_ball(path: str, slices: int, stacks: int) -> int:
    """A stand-in for the Mori shader ball, which the repository does not
    hold: Node5 (the shell) and Node2 (the core) as closed spheres of the
    port's ``geometry/creation``, and a third node that the loaders drop,
    in one ``.gltf`` with an external ``.bin`` → the triangles of one ball
    (Node5 and Node2)."""
    from torch_scene_files import GltfBuilder
    from bifrost3d_tpu_torch.geometry.creation import make_sphere
    g, tris = GltfBuilder(), 0
    for name, radius in (("Node5", 0.25), ("Node2", 0.18), ("Node3", 0.3)):
        mesh = make_sphere(radius=radius, slices=slices, stacks=stacks)
        pos = g.array(np.asarray(mesh.positions, np.float32), 5126, "VEC3")
        nrm = g.array(np.asarray(mesh.normals, np.float32), 5126, "VEC3")
        idx = g.array(np.asarray(mesh.indices, np.uint32).reshape(-1), 5125,
                      "SCALAR")
        g.node(mesh=g.mesh({"POSITION": pos, "NORMAL": nrm}, idx), name=name)
        if name != "Node3":
            tris += int(mesh.indices.shape[0])
    g.write(path, "bin")
    return tris


def camera_arrays(camera) -> dict:
    """A JAX PinholeCamera as the dict ``camera_from_numpy`` takes."""
    t = camera.transform
    return dict(translation=np.asarray(t.translation),
                rotation=np.asarray(t.rotation), scale=np.asarray(t.scale),
                projection=np.asarray(camera.projection),
                inverse_projection=np.asarray(camera.inverse_projection))


def assert_kernel_matches_plain(comp, n_tris, origin, direction, t_max,
                                live=None):
    """The CUDA dense trace against its plain PyTorch version on the same
    card tensors: one launch counted, prim equal on >= 99.9% of the live
    rays (nvcc's FMA contraction may flip near-edge hits and ties), t
    within rtol 1e-5 where prim agrees, rays past ``live`` missing."""
    import torch
    from bifrost3d_tpu_torch.geometry import pallas_intersect as dense

    before = dense.launch_count
    got = dense.pallas_intersect(comp, n_tris, origin, direction, 1e-4, t_max,
                                 live_count=live)
    torch.cuda.synchronize()
    assert dense.launch_count == before + 1
    ref = dense.dense_intersect_reference(comp, n_tris, origin, direction,
                                          1e-4, t_max, live)
    rows = slice(None) if live is None else slice(0, live)
    agree = got.prim[rows] == ref.prim[rows]
    assert agree.float().mean().item() >= 0.999
    same = agree & (ref.prim[rows] >= 0)
    torch.testing.assert_close(got.t[rows][same], ref.t[rows][same],
                               rtol=1e-5, atol=0.0)
    if live is not None:
        assert bool((got.prim[live:] == -1).all())
    return got


def assert_close_f32(got, ref, rtol=1e-5, atol=1e-6, share=0.995,
                     outlier_rtol=1e-3):
    """float32 parity of one formula in two frameworks: ``share`` of the
    elements within (rtol, atol), every element within (outlier_rtol,
    atol).

    The outlier bound exists for ill-conditioned lanes only: near a GGX
    lobe's peak, ``1 - cos²θ`` cancels, and XLA's jitted reciprocal square
    root (1 ulp from PyTorch's) is amplified there by 1/(1 - cos²θ).
    """
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=outlier_rtol, atol=atol)
    tight = np.isclose(got, ref, rtol=rtol, atol=atol)
    assert tight.mean() >= share, (tight.mean(), np.argwhere(~tight)[:8])


def assert_statistical_gate(img, ref, flip_budget=0.03, mean_budget=0.02):
    """The stochastic-frame gate of tests/test_pallas_mesh.py:25-42: at most
    ``flip_budget`` of the pixels differ by more than 1e-3, and the means
    agree within ``mean_budget`` (2%)."""
    img = np.asarray(img)
    ref = np.asarray(ref)
    assert img.shape == ref.shape
    assert np.isfinite(img).all()
    d = np.abs(img - ref).max(axis=-1)
    flips = float((d > 1e-3).mean())
    assert flips < flip_budget, flips
    bound = mean_budget * max(ref.mean(), 1e-3)
    assert abs(img.mean() - ref.mean()) < bound, (img.mean(), ref.mean())
    return flips


def prim_distances(hit, tris, origin, direction):
    """An any-hit Hit, whose t is t_min on a hit, with t replaced by the
    distance along each ray to the plane of the triangle it reports (inf on
    a miss), so the closest-hit gate can hold its prim off ties: a tie is
    two triangles the ray meets at one distance."""
    import torch
    from bifrost3d_tpu_torch.geometry.traverse import Hit, moller_trumbore
    v = tris[hit.prim.clamp_min(0).long()]
    t, _, _, _ = moller_trumbore(origin, direction, v[:, 0], v[:, 1], v[:, 2])
    return Hit(t=torch.where(hit.prim >= 0, t, float("inf")), prim=hit.prim,
               u=hit.u, v=hit.v)


# -- float64-anchored float32 parity ----------------------------------------

def _tree_map(fn, value):
    """``fn`` on every numpy leaf of nested dicts, lists, tuples and
    NamedTuples; other leaves (Python numbers, None) pass through."""
    if isinstance(value, np.ndarray):
        return fn(value)
    if isinstance(value, dict):
        return {k: _tree_map(fn, v) for k, v in value.items()}
    if hasattr(value, "_fields"):
        return type(value)(*(_tree_map(fn, v) for v in value))
    if isinstance(value, (list, tuple)):
        return type(value)(_tree_map(fn, v) for v in value)
    return value


def _leaves_numpy(value):
    """The array leaves of an output tree, in order, as numpy arrays."""
    if value is None:
        return []
    if hasattr(value, "_fields") or isinstance(value, (list, tuple)):
        return [leaf for v in value for leaf in _leaves_numpy(v)]
    if hasattr(value, "detach"):
        value = value.detach().cpu()
    return [np.asarray(value)]


def _run_port(port_fn, args, dtype):
    import torch

    def lift(a):
        if np.issubdtype(a.dtype, np.floating):
            return torch.tensor(a.astype(dtype))
        return torch.tensor(a)
    return _leaves_numpy(port_fn(*_tree_map(lift, args)))


def _run_jax(jax_fn, args, dtype, jit=False):
    import jax
    import jax.numpy as jnp

    def lift(a):
        if np.issubdtype(a.dtype, np.floating):
            return jnp.asarray(a.astype(dtype))
        return jnp.asarray(a)
    if dtype == np.float64:
        # JAX's own ``jnp.asarray(x, jnp.float32)`` casts would round
        # intermediates to float32 in its float64 run: map the name to
        # float64 for the call, so both sides run the formula in float64.
        f32 = jnp.float32
        try:
            jnp.float32 = jnp.float64
            with jax.enable_x64(True):
                return _leaves_numpy(jax_fn(*_tree_map(lift, args)))
        finally:
            jnp.float32 = f32
    if jit:
        return _leaves_numpy(jax.jit(jax_fn)(*_tree_map(lift, args)))
    return _leaves_numpy(jax_fn(*_tree_map(lift, args)))


# torch's float32 elementary functions on the CPU are faithful, not
# correctly rounded: on an AVX-512 host ``sqrt`` is off the IEEE root by one
# ulp on 20% of inputs (0.75 ulp at most), and sin, cos, exp and log are
# SLEEF's 1-ulp versions. Through a cancellation (``-b + sqrt(d)``,
# ``1 - sqrt(1 - x)``) that ulp grows to tens.
_ELEMENTARY = ("sqrt", "rsqrt", "sin", "cos", "exp", "log", "acos", "asin",
               "atan", "atan2", "tan", "log2", "exp2")


def _rounded_once(fn):
    """``fn`` for float32 tensors as its float64 value rounded once."""
    import torch

    def wrapped(*args, **kwargs):
        if any(isinstance(a, torch.Tensor) and a.dtype == torch.float32
               for a in args):
            args = [a.double() if isinstance(a, torch.Tensor) else a
                    for a in args]
            return fn(*args, **kwargs).float()
        return fn(*args, **kwargs)
    return wrapped


@contextlib.contextmanager
def elementary_rounded_once():
    """Within the block, every torch function of ``_ELEMENTARY`` on float32
    tensors is its float64 value rounded once: the port's own arithmetic,
    with the host library's elementary functions taken out."""
    import torch
    # Forward-mode AD scripts its decompositions (torch.jit) at its first
    # use in a process, and the script compiler cannot read the wrappers:
    # load them before patching.
    torch.func.jvp(torch.neg, (torch.zeros(1),), (torch.ones(1),))
    saved = {name: getattr(torch, name) for name in _ELEMENTARY}
    try:
        for name, fn in saved.items():
            setattr(torch, name, _rounded_once(fn))
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch, name, fn)


def _nudged(args, rng):
    """``args`` with every float input moved toward zero by 0, 1 or 2
    float32 ulps, drawn per element (zero stays zero, so no input leaves
    its domain)."""
    def nudge(a):
        if not np.issubdtype(a.dtype, np.floating):
            return a
        out = a.astype(np.float32)
        steps = rng.integers(0, 3, size=a.shape)
        for k in (1, 2):
            out = np.where(steps >= k, np.nextafter(out, np.float32(0)), out)
        return out
    return _tree_map(nudge, args)


def assert_f64_anchored(port_fn, jax_fn, *args, rtol64=1e-9, atol64=1e-15,
                        factor=2.0, ulps=4, nudges=4):
    """float32 parity of one function in two frameworks, anchored on
    float64, so that it holds on any host.

    ``args`` are numpy arrays (or trees of them, or Python numbers); float
    arrays are handed to both sides once as float32 and once as float64
    (JAX's under ``jax.enable_x64(True)``), integer and bool arrays as
    they are. For every float leaf of the output, on every lane:

    1. formula identity: the port's float64 value is within ``rtol64``
       (plus ``atol64``) of JAX's float64 value;
    2. the port's float32 error against JAX's float64 value is at most
       ``factor`` × JAX's float32 error (the largest of its eager and
       jitted runs, and of ``nudges`` eager runs at inputs 0–2 ulps away,
       each against float64 at its own inputs: XLA:CPU contracts a jitted
       formula to FMA, and one run's error is a single draw of the lane's
       range, which on an ill-conditioned lane is wide: without the nudged
       runs 8 of the 38 gated tests fail, each on 1–4 of its 2,048–12,288
       lanes, at 1.01–2.12 × the bound) plus ``ulps`` float32 ulps of the
       value. The port's float32 run takes
       its elementary functions rounded once from float64
       (``elementary_rounded_once``), so the bound holds the port's own
       arithmetic, not the host's libm.

    Bool and integer leaves are equal, in float32 and in float64. The
    float32 error of a formula depends on the host, so this gate bounds
    the port by JAX's own float32 error on the same host rather than by a
    tolerance tuned on one. A non-finite float64 value must come out the
    same in both float32 runs.
    """
    with elementary_rounded_once():
        p32 = _run_port(port_fn, args, np.float32)
    p64 = _run_port(port_fn, args, np.float64)
    j32 = _run_jax(jax_fn, args, np.float32)
    jit32 = _run_jax(jax_fn, args, np.float32, jit=True)
    rng = np.random.default_rng(0)
    nearby = []
    for _ in range(nudges):
        near = _nudged(args, rng)
        nearby.append((_run_jax(jax_fn, near, np.float32),
                       _run_jax(jax_fn, near, np.float64)))
    j64 = _run_jax(jax_fn, args, np.float64)
    assert len(p32) == len(j32) == len(p64) == len(j64), (len(p32), len(j32))
    for i, (a32, a64, b32, b64) in enumerate(zip(p32, p64, j32, j64)):
        assert a32.shape == b32.shape == a64.shape == b64.shape, (
            i, a32.shape, b32.shape)
        if not np.issubdtype(b64.dtype, np.floating):
            np.testing.assert_array_equal(a32, b32, err_msg=f"leaf {i}")
            np.testing.assert_array_equal(a64, b64, err_msg=f"leaf {i}")
            continue
        assert a64.dtype == b64.dtype == np.float64, (i, a64.dtype, b64.dtype)
        finite = np.isfinite(b64)
        np.testing.assert_array_equal(a64[~finite], b64[~finite],
                                      err_msg=f"leaf {i}: float64 non-finite")
        np.testing.assert_array_equal(a32[~finite], b32[~finite],
                                      err_msg=f"leaf {i}: float32 non-finite")
        ref = b64[finite]
        gap = np.abs(a64[finite] - ref)
        off = gap > rtol64 * np.abs(ref) + atol64
        assert not off.any(), (
            f"leaf {i}: float64 formulas differ on {int(off.sum())} lanes, "
            f"worst relative {float((gap / np.abs(ref).clip(1e-300)).max())}")
        err_p = np.abs(a32[finite].astype(np.float64) - ref)
        err_j = np.abs(b32[finite].astype(np.float64) - ref)
        err_j = np.fmax(err_j, np.abs(jit32[i][finite].astype(np.float64)
                                      - ref))
        for near32, near64 in nearby:
            err_j = np.fmax(err_j, np.abs(near32[i][finite].astype(np.float64)
                                          - near64[i][finite]))
        ulp = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)
        bound = factor * err_j + ulps * ulp
        bad = ~(err_p <= bound)
        assert not bad.any(), (
            f"leaf {i}: float32 error above {factor} x JAX's + {ulps} ulps on "
            f"{int(bad.sum())} of {bad.size} lanes; (port error, JAX error, "
            f"value): {list(zip(err_p[bad][:4], err_j[bad][:4], ref[bad][:4]))}")


# -- the host's spread ------------------------------------------------------
#
# ``JAX_PLATFORMS=cpu python3 tests/torch_parity.py``, from the repository
# root, prints how far float32 results of the port and of the JAX package
# move on the host's CPU: the numbers behind ``assert_f64_anchored`` and the
# measured tolerances of the gradient and Transmissive-frame tests.
#
# 1. sqrt: the share of float32 inputs whose ``torch.sqrt`` differs from
#    the IEEE root (numpy's), and torch's largest error in ulps;
# 2. conductor: ``adjust_conductor_specularity_to_exterior_medium``'s
#    largest float32 error against float64, in ulps of the value, for the
#    port, the port with its elementary functions rounded once from
#    float64, and JAX;
# 3. render_loss_grad: the light radius's cotangent on
#    test_torch_diff_grad.py's scene, the port's host run and its
#    rounded-once run against JAX's (relative);
# 4. optimize_materials: the roughness after three Adam steps of
#    test_torch_diff_optimize.py, the same two runs against JAX's;
# 5. Test frames: JAX's jitted frames against its eager ones, and the
#    port's against each, at 16 × 16: pixels off by more than 1e-3 in each
#    of 8 frames, and over the average of the 8 frames the pixels off by
#    more than 2% of their value, the glass sphere's mean and the frame's.


def _ulps(err, ref):
    return err / np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)


def _spread_sqrt():
    x = np.random.default_rng(0).uniform(0, 4, 1 << 20).astype(np.float32)
    got = torch.sqrt(torch.tensor(x)).numpy()
    ieee = np.sqrt(x)
    exact = np.sqrt(x.astype(np.float64))
    print(f"sqrt: torch float32 differs from the IEEE root on "
          f"{float((got != ieee).mean()):.4f} of {x.size} inputs; largest "
          f"error {float(_ulps(np.abs(got - exact), exact).max()):.3f} ulp "
          f"(IEEE {float(_ulps(np.abs(ieee - exact), exact).max()):.3f})")


def _spread_conductor():
    import jax.numpy as jnp
    from bifrost3d_tpu.bsdf import fresnel as jf
    from bifrost3d_tpu_torch.bsdf import fresnel as tf
    
    t = np.random.default_rng(5).uniform(0, 0.9999, 12288).astype(np.float32)

    def port(dtype):
        x = torch.tensor(t, dtype=dtype)
        return tf.adjust_conductor_specularity_to_exterior_medium(
            1.5, x, torch.zeros_like(x)).numpy().astype(np.float64)
    ref = port(torch.float64)
    host = port(torch.float32)
    with elementary_rounded_once():
        once = port(torch.float32)
    jax = np.asarray(jf.adjust_conductor_specularity_to_exterior_medium(
        1.5, jnp.asarray(t), jnp.zeros(t.shape))).astype(np.float64)
    worst = {name: float(_ulps(np.abs(v - ref), ref).max())
             for name, v in (("port", host), ("port rounded once", once),
                             ("JAX", jax))}
    print("conductor: largest float32 error against float64, ulps: "
          + ", ".join(f"{k} {v:.0f}" for k, v in worst.items()))


def _spread_gradients():
    import jax.numpy as jnp
    from bifrost3d_tpu.diff import optimize_materials as jax_optimize
    from bifrost3d_tpu.diff import render_loss_grad as jax_loss_grad
    from bifrost3d_tpu.integrator import path_tracer as jpt
    from bifrost3d_tpu_torch.diff import optimize_materials, render_loss_grad
    from bifrost3d_tpu_torch.integrator import path_tracer as tpt
    from bifrost3d_tpu_torch.scene.camera import camera_from_numpy
    from bifrost3d_tpu_torch.scene.render_scene import render_scene_from_numpy
    from test_torch_diff_grad import (SETTINGS, H, W, make_jax_camera,
                                      make_jax_scene)

    scene, cam = make_jax_scene(), make_jax_camera()
    _, jgrads = jax_loss_grad(scene, cam, jnp.zeros((H, W, 3)), W, H,
                              jnp.uint32(0), SETTINGS)
    want = float(np.asarray(jgrads.lights.radius)[0])
    port_scene = render_scene_from_numpy(scene_arrays(scene), device="cpu")
    port_cam = camera_from_numpy(camera_arrays(cam), device="cpu")

    def radius():
        _, g = render_loss_grad(port_scene, port_cam, torch.zeros(H, W, 3),
                                W, H, 0, tpt.RenderSettings(*SETTINGS))
        return float(g.lights.radius[0])
    host = radius()
    with elementary_rounded_once():
        once = radius()
    print(f"render_loss_grad: light radius cotangent, JAX {want:.7e}; port "
          f"{abs(host - want) / abs(want):.3e} off (relative), rounded once "
          f"{abs(once - want) / abs(want):.3e}")

    settings = SETTINGS._replace(max_bounce_count=1)
    target = jpt.render_sample(make_jax_scene(tint=(0.8, 0.2, 0.5)), cam, W,
                               H, 0, settings)
    start = make_jax_scene(tint=(0.4, 0.6, 0.3))
    jrun = jax_optimize(start, cam, target, W, H, steps=3, learning_rate=0.1,
                        vary_samples=False, settings=settings)
    want = float(np.asarray(jrun.scene.materials.roughness)[0])
    port_start = render_scene_from_numpy(scene_arrays(start), device="cpu")

    def roughness():
        run = optimize_materials(
            port_start, port_cam, torch.tensor(np.asarray(target)), W, H,
            steps=3, learning_rate=0.1, vary_samples=False,
            settings=tpt.RenderSettings(*settings))
        return float(run.scene.materials.roughness[0])
    host = roughness()
    with elementary_rounded_once():
        once = roughness()
    print(f"optimize_materials: roughness after 3 Adam steps, JAX {want:.7f};"
          f" port {abs(host - want):.3e} off, rounded once "
          f"{abs(once - want):.3e}")


def _spread_frames(accumulations=8):
    import jax
    import jax.numpy as jnp
    from bifrost3d_tpu.apps import scenes as jscenes
    from bifrost3d_tpu.integrator import path_tracer as jpt
    from bifrost3d_tpu_torch.integrator import path_tracer as tpt
    from bifrost3d_tpu_torch.scene.camera import camera_from_numpy
    from bifrost3d_tpu_torch.scene.render_scene import render_scene_from_numpy
    from test_torch_transmissive_frames import _glass_pixels

    jscene, jcam = jscenes.SCENES["Test"]()
    scene = render_scene_from_numpy(scene_arrays(jscene), device="cpu")
    cam = camera_from_numpy(camera_arrays(jcam), device="cpu")
    jset = jpt.settings_for_scene(jscene, max_bounce_count=4)
    tset = tpt.settings_for_scene(scene, max_bounce_count=4)
    accs = range(accumulations)
    frames = {"jit": [], "eager": [], "port": []}
    for acc in accs:
        frames["jit"].append(np.asarray(jpt.render_sample(
            jscene, jcam, 16, 16, jnp.uint32(acc), jset)))
        with jax.disable_jit():
            frames["eager"].append(np.asarray(jpt.render_sample(
                jscene, jcam, 16, 16, jnp.uint32(acc), jset)))
        frames["port"].append(tpt.render_sample(scene, cam, 16, 16, acc,
                                                tset).numpy())
    glass = _glass_pixels(scene, cam, accs)
    print(f"Test frames, 16x16, 4 bounces, accumulations 0-{accs[-1]}; the "
          f"glass sphere covers {int(glass.sum())} pixels")
    for a, b in (("jit", "eager"), ("port", "jit"), ("port", "eager")):
        one = [float((np.abs(x - y).max(axis=-1) > 1e-3).mean())
               for x, y in zip(frames[a], frames[b])]
        mean_a, mean_b = np.mean(frames[a], axis=0), np.mean(frames[b],
                                                             axis=0)
        off = (np.abs(mean_a - mean_b).max(axis=-1)
               / np.maximum(mean_b.max(axis=-1), 1e-3))
        print(f"  {a} vs {b}: pixels off by > 1e-3 a frame "
              + " ".join(f"{x:.4f}" for x in one)
              + f"; the average of the frames: pixels off by > 2% "
              f"{float((off > 0.02).mean()):.4f}, largest {float(off.max()):.4f}"
              f", the sphere's mean {float(mean_a[glass].mean() / mean_b[glass].mean() - 1):+.5f}"
              f", the frame's mean {float(mean_a.mean() / mean_b.mean() - 1):+.5f}")


def spread_report() -> int:
    _spread_sqrt()
    _spread_conductor()
    _spread_gradients()
    _spread_frames()
    return 0


if __name__ == "__main__":
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(spread_report())
