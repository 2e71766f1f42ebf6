"""Shared helpers for the parity tests of the PyTorch port (test_torch_*.py).

Data crosses between the JAX package and the port as numpy arrays only.
"""

from __future__ import annotations

import numpy as np


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
