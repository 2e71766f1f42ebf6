"""Sharded progressive rendering and sharded inverse rendering over a mesh.

Port of ``bifrost3d_tpu/parallel/render.py``. Pixel rows shard over the
``'tiles'`` axis of a mesh (``parallel/mesh.py``: an ordered list of torch
devices); the scene and the camera replicate on every device. JAX runs the
shards under ``shard_map``; here one process renders each shard's padded
row block on its device in mesh order, concatenates the blocks on the
mesh's first device and crops the padding rows.

- Forward renders need no collective: each shard's pooled wavefront
  finishes its own pixel range (``render_pixels_pooled(pixel_start,
  n_pixels)``). On a CUDA card that wavefront launches the scene's trace
  kernel: the dense trace (``csrc/dense_intersect.cu``) up to 65,536
  triangles, the BVH trace (``csrc/bvh_intersect.cu``) above.
- The train steps sum each shard's squared error and gradients in mesh
  order, which stands in for JAX's ``psum`` all-reduce, then divide by the
  frame's element count and take one replicated Adam step (optax's
  ``adam`` formula) and JAX's clamps. Rows past the image's height are
  padding and add no error.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bifrost3d_tpu_torch.diff.mesh_edge_grad import (
    MeshEdges,
    _det,
    _edge_samples,
    _screen_derivatives,
    _silhouette,
)
from bifrost3d_tpu_torch.geometry.pallas_intersect import pack_triangles
from bifrost3d_tpu_torch.integrator.path_tracer import (
    RenderSettings,
    render_pixels_pooled,
    render_rays,
    render_sample_pixels,
)
from bifrost3d_tpu_torch.integrator.smallpt import render_smallpt_pixels
from bifrost3d_tpu_torch.parallel.mesh import (
    pad_to_multiple,
    render_mesh,
    tile_sharding,
)
from bifrost3d_tpu_torch.sampling.hashes import pcg2d
from bifrost3d_tpu_torch.scene.camera import (
    camera_ray_directions,
    project_to_screen,
)
from bifrost3d_tpu_torch.scene.spheres import SphereScene
from bifrost3d_tpu_torch.utils.tree import tree_to

# The geometry steps take scenes of up to this many triangles, as JAX's do
# (its BRUTE_FORCE_MAX_TRIS): above it JAX's shifted scene would trace a
# BVH built for the untranslated mesh.
GEOMETRY_MAX_TRIS = 4096

_MATERIAL_PARAMS = ("tint", "roughness", "specularity", "metallic",
                    "emission")


def _row_split(mesh, height: int):
    """→ (padded height, rows per shard)."""
    padded_h = pad_to_multiple(height, len(mesh))
    return padded_h, padded_h // len(mesh)


def pixel_rows(first_row: int, rows: int, width: int, device):
    """int64 pixel coordinates (x, y), each [rows, width], of the row block
    starting at ``first_row``."""
    y, x = torch.meshgrid(
        torch.arange(first_row, first_row + rows, device=device),
        torch.arange(width, device=device), indexing="ij")
    return x, y


def _gather(blocks, device):
    return torch.cat([b.to(device) for b in blocks])


# ---------------------------------------------------------------------------
# SmallPT
# ---------------------------------------------------------------------------

def smallpt_shard(scene: SphereScene, width: int, height: int, accumulation,
                  first_row: int, rows: int, device):
    """One shard's rows [first_row, first_row + rows) of a SmallPT frame
    → [rows, width, 3] on ``device``."""
    x, y = pixel_rows(first_row, rows, width, device)
    return render_smallpt_pixels(tree_to(scene, device), x, y, width,
                                 height, int(accumulation))


def make_sharded_smallpt(mesh, width: int, height: int):
    """Sharded SmallPT frame: render(scene, accumulation) → [H, W, 3] on the
    mesh's first device (row 0 = bottom, like the reference). Rows are
    padded to a multiple of the mesh size, rendered per shard and
    cropped."""
    mesh = list(mesh)
    _, rows = _row_split(mesh, height)

    def render(scene: SphereScene, accumulation):
        blocks = [smallpt_shard(scene, width, height, accumulation, i * rows,
                                rows, d) for i, d in enumerate(mesh)]
        return _gather(blocks, mesh[0])[:height]

    return render


def render_smallpt_sharded(scene: SphereScene, width: int, height: int,
                           accumulations: int, mesh=None) -> torch.Tensor:
    """Progressive sharded render: the running mean of ``accumulations``
    frames (accumulations 1..n)."""
    mesh = render_mesh() if mesh is None else list(mesh)
    render = make_sharded_smallpt(mesh, width, height)
    buffer = torch.zeros((height, width, 3), device=mesh[0])
    for n in range(1, accumulations + 1):
        frame = render(scene, n)
        buffer = buffer + (frame - buffer) / n
    return buffer


# ---------------------------------------------------------------------------
# The mesh-scene wavefront over the mesh (the production path)
# ---------------------------------------------------------------------------

def pooled_shard(scene, camera, width: int, height: int, accumulation,
                 settings: RenderSettings, pool_size: int, shard: int,
                 shard_rows: int, device):
    """Shard ``shard``'s flat pixel range (``shard_rows`` whole rows)
    through the pooled wavefront → [shard_rows, width, 3] on ``device``."""
    shard_pixels = shard_rows * width
    accum, _ = render_pixels_pooled(
        tree_to(scene, device), tree_to(camera, device), width, height,
        accumulation, settings, pool_size=min(pool_size, shard_pixels),
        pixel_start=shard * shard_pixels, n_pixels=shard_pixels)
    return accum.reshape(shard_rows, width, 3)


def make_sharded_render(mesh, width: int, height: int, settings=None,
                        pool_size: int = 65536):
    """Sharded mesh-scene render: render(scene, camera, accumulation) →
    [H, W, 3] on the mesh's first device.

    Each shard renders its flat pixel range through the pooled compacting
    wavefront, whose loop runs until its own range is done: shards finish
    independently, with no collective. Padding rows past ``height`` render
    the frame's last pixel and are cropped.
    """
    settings = settings or RenderSettings()
    mesh = list(mesh)
    _, rows = _row_split(mesh, height)

    def render(scene, camera, accumulation):
        blocks = [pooled_shard(scene, camera, width, height, accumulation,
                               settings, pool_size, i, rows, d)
                  for i, d in enumerate(mesh)]
        return _gather(blocks, mesh[0])[:height]

    return render


# ---------------------------------------------------------------------------
# The silhouette boundary term
# ---------------------------------------------------------------------------

def _bilinear_nearest(image, ty, tx):
    """``map_coordinates(image[..., c], [ty, tx], order=1, mode="nearest")``
    for every channel: the four neighbours' product weights, indices
    clamped to the edge, summed in JAX's order → [m, c]."""
    h, w = image.shape[0], image.shape[1]
    y0 = torch.floor(ty)
    x0 = torch.floor(tx)
    wy1, wx1 = ty - y0, tx - x0
    ys = ((y0.long(), 1 - wy1), (y0.long() + 1, wy1))
    xs = ((x0.long(), 1 - wx1), (x0.long() + 1, wx1))
    out = None
    for iy, wy in ys:
        for ix, wx in xs:
            term = (wy * wx)[:, None] * image[iy.clamp(0, h - 1),
                                              ix.clamp(0, w - 1)]
            out = term if out is None else out + term
    return out


@torch.no_grad()
def silhouette_translation_boundary_grad(shifted_scene, translation, camera,
                                         target, edges: MeshEdges, width,
                                         height, accumulation, settings,
                                         samples_per_edge):
    """Loss-adjoint-weighted silhouette boundary term → translation grad [3].

    Edge-sampled estimator (``diff/mesh_edge_grad.py``): for loss =
    mean((I−T)²) the boundary integrand is (L₋−T(q))² − (L₊−T(q))² per
    channel, with T bilinearly sampled at the edge's image position; the
    two probes of a pair share a pixel hash, so the estimator's noise is
    common-mode and cancels in ΔL. JAX's per-sample ``jax.jvp`` and
    ``jacfwd`` are batched ``torch.func.jvp`` calls. Replicated: a few
    hundred probes on the device of ``shifted_scene``.
    """
    e, k = edges.v0.shape[0], samples_per_edge
    _, x, edge_dir = _edge_samples(edges, translation, k)
    silhouette = _silhouette(x, camera.transform.translation, edges)
    q, w, dq_ds, dq_dt = _screen_derivatives(
        lambda p: project_to_screen(camera, p), x.reshape(-1, 3), edge_dir)
    inside = (w > 0.0) & torch.all((q >= 0.0) & (q <= 1.0), dim=-1)
    t_len = torch.sqrt(torch.sum(dq_ds * dq_ds, dim=-1))
    n_img = torch.stack([-dq_ds[:, 1], dq_ds[:, 0]], dim=-1) \
        / torch.clamp_min(t_len, 1e-12)[:, None]
    eps = 1.5e-3

    # One hash for both probes of a pair: their noise cancels in ΔL.
    xi = torch.clamp(q[:, 0] * width, 0, width - 1).to(torch.int64)
    yi = torch.clamp((1.0 - q[:, 1]) * height, 0, height - 1).to(torch.int64)
    probe_hash, _ = pcg2d(xi, yi)

    def probe(uv):
        o, d = camera_ray_directions(camera, uv)
        return render_rays(shifted_scene, o, d, probe_hash, accumulation,
                           settings)

    l_minus = probe(torch.clamp(q - eps * n_img, 0.0, 1.0))
    l_plus = probe(torch.clamp(q + eps * n_img, 0.0, 1.0))

    # The target bilinearly sampled at q (image row 0 = viewport v = 1).
    ty = (1.0 - q[:, 1]) * height - 0.5
    tx = q[:, 0] * width - 0.5
    t_at_q = _bilinear_nearest(target.to(q.device), ty, tx)
    # loss = ∫ Σ_c (I−T)² du / 3 in continuous image space, so the
    # boundary integrand carries the same 1/3 channel normalization.
    delta_f = torch.sum(torch.square(l_minus - t_at_q)
                        - torch.square(l_plus - t_at_q), dim=-1) / 3.0
    contrib = torch.where(silhouette & inside, delta_f, 0.0)[:, None] \
        * _det(dq_ds, dq_dt)
    return torch.sum(contrib.reshape(e, k, 3), dim=(0, 1)) / k


# ---------------------------------------------------------------------------
# Adam with optax's formula
# ---------------------------------------------------------------------------

class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the step count and both moments."""

    count: int
    mu: dict
    nu: dict


def adam_init(params: dict) -> AdamState:
    return AdamState(0, {k: torch.zeros_like(v) for k, v in params.items()},
                     {k: torch.zeros_like(v) for k, v in params.items()})


def adam_update(params: dict, grads: dict, state: AdamState,
                learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8):
    """One step of ``optax.adam(learning_rate)`` → (params, state): moments
    (1 − b)·g^k + b·m, bias correction 1 − b^count in float32, update
    −lr · m̂ / (√v̂ + eps) added to the parameter."""
    count = state.count + 1
    mu, nu, out = {}, {}, {}
    for name, p in params.items():
        g = grads[name]
        mu[name] = (1 - b1) * g + b1 * state.mu[name]
        nu[name] = (1 - b2) * g ** 2 + b2 * state.nu[name]
        decay1 = 1 - torch.tensor(b1, dtype=p.dtype, device=p.device) ** count
        decay2 = 1 - torch.tensor(b2, dtype=p.dtype, device=p.device) ** count
        update = (mu[name] / decay1) / (torch.sqrt(nu[name] / decay2) + eps)
        out[name] = p + (-learning_rate) * update
    return out, AdamState(count, mu, nu)


# ---------------------------------------------------------------------------
# Sharded train steps
# ---------------------------------------------------------------------------

def _check_geometry_scene(scene):
    n = int(scene.tri_verts.shape[0])
    if n > GEOMETRY_MAX_TRIS:
        raise ValueError(
            f"sharded geometry train step supports scenes up to "
            f"{GEOMETRY_MAX_TRIS} triangles (got {n}); larger scenes would "
            f"fall through to a BVH built for the untranslated mesh")


def _translated(scene, tri_range, translation):
    """The scene with triangles [t0, t1) moved by ``translation`` (autograd
    flows into it through the vertex positions), its dense trace table
    packed anew from the moved soup and its BVH packing dropped: the trace
    sees the moved geometry, and the hit query stays detached."""
    _check_geometry_scene(scene)
    t0, t1 = tri_range
    tv = scene.tri_verts
    shifted = torch.cat([tv[:t0], tv[t0:t1] + translation[None, None, :],
                         tv[t1:]])
    return scene._replace(tri_verts=shifted,
                          tri_components=pack_triangles(shifted.detach())[0],
                          tri_clustered=None)


def _sharded_loss_grads(mesh, params: dict, scene_of, camera, target,
                        width: int, height: int, accumulation,
                        settings: RenderSettings):
    """Σ over shards of the squared error and of its gradients w.r.t.
    ``params``, summed in mesh order on the mesh's first device (the
    stand-in for JAX's psum), each divided by the frame's element count.
    ``scene_of(scene_on_device, params_on_device)`` makes the rendered
    scene."""
    padded_h, rows = _row_split(mesh, height)
    target_pad = torch.zeros((padded_h, width, 3), dtype=target.dtype,
                             device=target.device)
    target_pad[:height] = target
    denom = float(width * height * 3)
    root = mesh[0]
    loss_sum, grad_sum = None, None
    for i, (d, rows_target) in enumerate(
            zip(mesh, tile_sharding(mesh).place(target_pad))):
        local = {k: v.detach().to(d).requires_grad_()
                 for k, v in params.items()}
        x, y = pixel_rows(i * rows, rows, width, d)
        img = render_sample_pixels(scene_of(d, local), tree_to(camera, d),
                                   x, y, width, height, accumulation,
                                   settings)
        in_image = (y < height)[..., None]
        loss = torch.sum(torch.where(in_image,
                                     torch.square(img - rows_target), 0.0))
        grads = torch.autograd.grad(loss, list(local.values()),
                                    allow_unused=True)
        grads = {k: (torch.zeros_like(v) if g is None else g).to(root)
                 for (k, v), g in zip(local.items(), grads)}
        loss = loss.detach().to(root)
        if loss_sum is None:
            loss_sum, grad_sum = loss, grads
        else:
            loss_sum = loss_sum + loss
            grad_sum = {k: grad_sum[k] + g for k, g in grads.items()}
    return loss_sum / denom, {k: g / denom for k, g in grad_sum.items()}


def make_sharded_train_step(mesh, width: int, height: int,
                            settings=None, learning_rate: float = 5e-2,
                            tri_range=None, object_edges=None,
                            samples_per_edge: int = 16):
    """Sharded inverse-rendering step: the forward wavefront over sharded
    pixel rows, the backward through shading and lights, the gradients
    summed over the shards, a replicated Adam update.

    Parameters: material ``tint``, ``roughness``, ``specularity``,
    ``metallic``, ``emission`` and ``light_power``; with ``tri_range``
    (and, for the silhouette boundary term, ``object_edges``, a
    :class:`MeshEdges`) also a ``translation`` [3] of that triangle range.

    Returns (init_fn, step_fn):
      init_fn(scene) -> (params, opt_state)
      step_fn(params, opt_state, scene, camera, target, accumulation)
          -> (params, opt_state, loss)
    """
    settings = settings or RenderSettings()
    mesh = list(mesh)
    with_geometry = tri_range is not None

    def apply_params(scene, p):
        mats = scene.materials._replace(**{k: p[k] for k in _MATERIAL_PARAMS})
        lights = scene.lights._replace(power=p["light_power"])
        scene = scene._replace(materials=mats, lights=lights)
        if with_geometry:
            scene = _translated(scene, tri_range, p["translation"])
        return scene

    def init_fn(scene):
        params = {k: getattr(scene.materials, k).detach().clone()
                  for k in _MATERIAL_PARAMS}
        params["light_power"] = scene.lights.power.detach().clone()
        if with_geometry:
            params["translation"] = torch.zeros(
                3, device=scene.tri_verts.device)
        return params, adam_init(params)

    def step_fn(params, opt_state, scene, camera, target, accumulation):
        accumulation = int(accumulation)
        loss, grads = _sharded_loss_grads(
            mesh, params, lambda d, p: apply_params(tree_to(scene, d), p),
            camera, target, width, height, accumulation, settings)
        if with_geometry and object_edges is not None:
            root = mesh[0]
            replicated = {k: v.to(root) for k, v in params.items()}
            grads["translation"] = grads["translation"] + \
                silhouette_translation_boundary_grad(
                    apply_params(tree_to(scene, root), replicated),
                    replicated["translation"], tree_to(camera, root),
                    target, tree_to(object_edges, root), width, height,
                    accumulation, settings, samples_per_edge)
        params = {k: v.to(mesh[0]) for k, v in params.items()}
        params, opt_state = adam_update(params, grads, opt_state,
                                        learning_rate)
        clipped = {"tint": torch.clamp(params["tint"], 0.0, 1.0),
                   "roughness": torch.clamp(params["roughness"], 0.02, 1.0),
                   "specularity": torch.clamp(params["specularity"], 0.0, 1.0),
                   "metallic": torch.clamp(params["metallic"], 0.0, 1.0),
                   "emission": torch.clamp_min(params["emission"], 0.0),
                   "light_power": torch.clamp_min(params["light_power"], 0.0)}
        if with_geometry:
            clipped["translation"] = params["translation"]
        return clipped, opt_state, loss

    return init_fn, step_fn


def make_sharded_geometry_train_step(mesh, width: int, height: int,
                                     tri_range, object_edges,
                                     settings=None,
                                     learning_rate: float = 2e-2,
                                     samples_per_edge: int = 16):
    """Sharded inverse-rendering step over an object's TRANSLATION.

    The gradient combines the interior (pathwise) term, autograd through
    the moved triangles' attributes summed over the shards like the
    material step's, and the silhouette boundary term
    (:func:`silhouette_translation_boundary_grad`), replicated.
    ``tri_range = (start, end)`` is the object's triangle range in the
    scene's soup; scenes of up to ``GEOMETRY_MAX_TRIS`` triangles.

    Returns (init_fn, step_fn):
      init_fn() -> (translation [3], opt_state)
      step_fn(translation, opt_state, scene, camera, target, accumulation)
          -> (translation, opt_state, loss)
    """
    settings = settings or RenderSettings()
    mesh = list(mesh)

    def init_fn():
        translation = torch.zeros(3, device=mesh[0])
        return translation, adam_init({"translation": translation})

    def step_fn(translation, opt_state, scene, camera, target, accumulation):
        accumulation = int(accumulation)
        loss, grads = _sharded_loss_grads(
            mesh, {"translation": translation},
            lambda d, p: _translated(tree_to(scene, d), tri_range,
                                     p["translation"]),
            camera, target, width, height, accumulation, settings)
        root = mesh[0]
        translation = translation.to(root)
        grad = grads["translation"] + silhouette_translation_boundary_grad(
            _translated(tree_to(scene, root), tri_range, translation),
            translation, tree_to(camera, root), target,
            tree_to(object_edges, root), width, height, accumulation,
            settings, samples_per_edge)
        params, opt_state = adam_update({"translation": translation},
                                        {"translation": grad}, opt_state,
                                        learning_rate)
        return params["translation"], opt_state, loss

    return init_fn, step_fn
