"""GGX-reflection LTC fit table.

Port of ``bifrost3d_tpu/shading/ltc_fit.py``: the counterpart of
``Assets/Shading/GGXLinearlyTransformedCosines.cpp`` (the 64 × 64
(cos θ × roughness) grid of isotropic LTC parameters) and of the LTC
fitting pass of ``apps/dev/MaterialPrecomputations``. As with the rho
fittings, the table is fitted against the port's own GGX, so table and
BSDF cannot drift apart.

The fit is JAX's: a whole roughness row of 64 cells runs as ONE batched
Nelder–Mead on the device (reflect, expand, contract and shrink selected
per cell with ``torch.where``), the rows marching from roughness 1 down to
0, each warm-started from the previous row's solution (Heitz et al. 2016
§5). Error metric: the MIS-weighted L3 distance between the LTC density
and the normalized GGX D·G lobe over stratified samples from both.

:func:`get_ggx_ltc_table` reads the table the JAX package ships
(``bifrost3d_tpu/shading/data/ggx_ltc.npz``) by path. ``python -m
bifrost3d_tpu_torch.shading.ltc_fit`` fits the table on the card and
writes ``build/shading/ggx_ltc.npz``.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from bifrost3d_tpu_torch.bsdf import ggx
from bifrost3d_tpu_torch.math import ltc as ltc_math
from bifrost3d_tpu_torch.math.clip import clip, maximum
from bifrost3d_tpu_torch.math.ltc import IsotropicLTC

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TABLE_PATH = os.path.join(_REPO, "bifrost3d_tpu", "shading", "data",
                          "ggx_ltc.npz")
BUILD_PATH = os.path.join(_REPO, "build", "shading", "ggx_ltc.npz")

ANGLE_SAMPLES = 64
ROUGHNESS_SAMPLES = 64
_FIT_SAMPLES = 16 * 16      # stratified u2 points per sample set
_NM_ITERATIONS = 200
_MIN_FIT_ALPHA = 2e-4       # just above ggx.MIN_ALPHA: off the delta path
_MIN_FIT_COS = 0.02


def _stratified_u2(n_side: int, device=None, dtype=torch.float32):
    """n_side² stratified 2-d points at cell centres → [K, 2]."""
    g = (torch.arange(n_side, dtype=dtype, device=device) + 0.5) / n_side
    gx, gy = torch.meshgrid(g, g, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)


def _params_to_ltc(p):
    """p[..., 4] = (log m00, log m11, m02, m20); m22 fixed to 1."""
    return IsotropicLTC(
        m00=torch.exp(p[..., 0]), m11=torch.exp(p[..., 1]),
        m22=torch.ones_like(p[..., 0]), m02=p[..., 2], m20=p[..., 3])


def _make_row_objective(cos_grid, alpha, u2):
    """Objective of one roughness row: params [B, M, 4] → error [B, M].

    B = len(cos_grid) independent fits, M the candidates of the batched
    Nelder–Mead. Sample set A (from the GGX lobe) does not depend on the
    parameters and is drawn here; set B (from the LTC) per evaluation.
    """
    b, k = cos_grid.shape[0], u2.shape[0]
    sin_t = torch.sqrt(maximum(1.0 - cos_grid * cos_grid, 0.0))
    wo = torch.stack([sin_t, torch.zeros_like(cos_grid), cos_grid], dim=-1)

    wo_k = torch.broadcast_to(wo[:, None, :], (b, k, 3))
    alpha = torch.as_tensor(alpha, dtype=cos_grid.dtype,
                            device=cos_grid.device)
    s = ggx.r_sample(alpha.expand(b, k), 1.0, wo_k, u2[None, :, :])
    wi_a = s.direction                      # [B, K, 3]
    pdf_g_a = maximum(s.pdf, 0.0)           # [B, K]

    def d_ggx(wi, wo_b, rho):
        f = ggx.r_evaluate(alpha, 1.0, wo_b, wi)[..., 0]
        return f * maximum(wi[..., 2], 0.0) / rho

    # Normalization: rho = ∫ f·cos through the same GGX samples.
    f_a = ggx.r_evaluate(alpha, 1.0, wo_k, wi_a)[..., 0]
    contrib = torch.where(pdf_g_a > 1e-12,
                          f_a * maximum(wi_a[..., 2], 0.0)
                          / maximum(pdf_g_a, 1e-12), 0.0)
    rho = maximum(torch.mean(contrib, dim=-1), 1e-6)     # [B]
    d_g_a = d_ggx(wi_a, wo_k, rho[:, None])              # [B, K]

    def objective(p):                                     # p: [B, M, 4]
        lk = IsotropicLTC(*(x[..., None] for x in _params_to_ltc(p)))

        # Set A: GGX-sampled directions.
        pdf_l_a = ltc_math.pdf(lk, wi_a[:, None, :, :])   # [B, M, K]
        err_a = torch.abs(pdf_l_a - d_g_a[:, None, :]) ** 3 \
            / (pdf_g_a[:, None, :] + pdf_l_a + 1e-8)

        # Set B: LTC-sampled directions (they depend on the parameters).
        wi_b, pdf_l_b = ltc_math.sample(lk, u2[None, None, :, :])
        wo_b = torch.broadcast_to(wo[:, None, None, :], wi_b.shape)
        pdf_g_b = ggx.r_pdf(alpha, wo_b, wi_b)
        d_g_b = d_ggx(wi_b, wo_b, rho[:, None, None])
        err_b = torch.abs(pdf_l_b - d_g_b) ** 3 / (pdf_g_b + pdf_l_b + 1e-8)

        return torch.mean(err_a, dim=-1) + torch.mean(err_b, dim=-1)

    return objective


def _nelder_mead_step(f, simplex, values):
    """One iteration of the batched Nelder–Mead → (simplex, values)."""
    order = torch.argsort(values, dim=-1, stable=True)
    values = torch.take_along_dim(values, order, dim=-1)
    simplex = torch.take_along_dim(simplex, order[..., None], dim=1)

    best_v, second_worst_v, worst_v = (values[:, 0], values[:, -2],
                                       values[:, -1])
    worst = simplex[:, -1]
    centroid = torch.mean(simplex[:, :-1], dim=1)

    reflected = 2.0 * centroid - worst
    expanded = 3.0 * centroid - 2.0 * worst
    contracted = 0.5 * (centroid + worst)
    fc3 = f(torch.stack([reflected, expanded, contracted], dim=1))
    fr, fe, fc = fc3[:, 0], fc3[:, 1], fc3[:, 2]

    take_reflect = (best_v <= fr) & (fr < second_worst_v)
    expand_better = fe < fr
    take_expand = (fr < best_v) & expand_better
    take_reflect = take_reflect | ((fr < best_v) & ~expand_better)
    take_contract = ~(take_reflect | take_expand) & (fc < worst_v)
    shrink = ~(take_reflect | take_expand | take_contract)

    new_worst = torch.where(
        take_expand[:, None], expanded,
        torch.where(take_reflect[:, None], reflected,
                    torch.where(take_contract[:, None], contracted, worst)))
    new_worst_v = torch.where(
        take_expand, fe,
        torch.where(take_reflect, fr,
                    torch.where(take_contract, fc, worst_v)))
    moved_simplex = torch.cat([simplex[:, :-1], new_worst[:, None]], dim=1)
    moved_values = torch.cat([values[:, :-1], new_worst_v[:, None]], dim=-1)

    shrunk_simplex = simplex[:, :1] + 0.5 * (simplex - simplex[:, :1])
    shrunk_values = f(shrunk_simplex)

    return (torch.where(shrink[:, None, None], shrunk_simplex, moved_simplex),
            torch.where(shrink[:, None], shrunk_values, moved_values))


def _batched_nelder_mead(f, x0, iterations: int, step: float = 0.05,
                         graph: bool = True):
    """Minimize f: [B, M, n] → [B, M] independently per batch element →
    (best point [B, n], its value [B]).

    JAX's where-selected simplex updates (reflect / expand / contract /
    shrink with the 1 / 2 / 0.5 / 0.5 coefficients of ``Math/NelderMead.h``):
    every iteration evaluates the three candidates and the shrunk simplex
    for all cells and keeps, per cell, what its branch takes. On a CUDA
    card (and ``graph``) the iteration is captured once as a CUDA graph and
    replayed, as JAX compiles its ``fori_loop`` body once: the same kernels
    on the same buffers, so the same bits, without ~500 launches from the
    host per iteration.
    """
    b, n = x0.shape
    eye = torch.eye(n, dtype=x0.dtype, device=x0.device)
    simplex = torch.cat([x0[:, None, :], x0[:, None, :] + step * eye[None]],
                        dim=1)
    values = f(simplex)                                   # [B, n+1]
    if graph and x0.device.type == "cuda" and iterations > 0:
        # The first iteration runs on a side stream (the warm-up a capture
        # needs); the captured one writes back into its own inputs.
        side = torch.cuda.Stream(x0.device)
        side.wait_stream(torch.cuda.current_stream(x0.device))
        with torch.cuda.stream(side):
            simplex, values = _nelder_mead_step(f, simplex, values)
        torch.cuda.current_stream(x0.device).wait_stream(side)
        simplex, values = simplex.clone(), values.clone()
        step_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(step_graph):
            new_simplex, new_values = _nelder_mead_step(f, simplex, values)
            simplex.copy_(new_simplex)
            values.copy_(new_values)
        for _ in range(iterations - 1):
            step_graph.replay()
    else:
        for _ in range(iterations):
            simplex, values = _nelder_mead_step(f, simplex, values)

    best = torch.argmin(values, dim=-1)
    return (torch.take_along_dim(simplex, best[:, None, None], dim=1)[:, 0],
            torch.take_along_dim(values, best[:, None], dim=-1)[:, 0])


def fit_row(cos_grid, alpha: float, x0, u2, iterations: int,
            graph: bool = True):
    """One roughness row: the batched Nelder–Mead from ``x0`` [B, 4] →
    (parameters [B, 4] in (log m00, log m11, m02, m20), objective [B])."""
    return _batched_nelder_mead(_make_row_objective(cos_grid, alpha, u2), x0,
                                iterations, graph=graph)


def _row_alpha(j: int, roughness_samples: int) -> float:
    roughness = j / (roughness_samples - 1)
    return float(np.float32(max(roughness * roughness, _MIN_FIT_ALPHA)))


def precompute_ggx_ltc(save_path=BUILD_PATH,
                       angle_samples: int = ANGLE_SAMPLES,
                       roughness_samples: int = ROUGHNESS_SAMPLES, *,
                       device=None):
    """Fit the (cos θ × roughness) grid on ``device`` (the card by
    default) → [R, C, 4] float32 numpy (m00, m11, m02, m20), m22 ≡ 1; the
    value at index i sits at coordinate i/(n-1), as the rho tables'.
    Written to ``save_path`` when one is given."""
    device = torch.device(device if device is not None else "cuda")
    cos_grid = maximum(torch.arange(angle_samples, dtype=torch.float32,
                                    device=device) / (angle_samples - 1),
                       _MIN_FIT_COS)
    u2 = _stratified_u2(int(np.sqrt(_FIT_SAMPLES)), device)

    rows = [None] * roughness_samples
    # March from rough (an identity-like lobe) to smooth, warm-starting.
    x0 = torch.zeros((angle_samples, 4), device=device)
    with torch.no_grad():
        for j in reversed(range(roughness_samples)):
            x0, _ = fit_row(cos_grid, _row_alpha(j, roughness_samples), x0,
                            u2, _NM_ITERATIONS)
            rows[j] = x0.cpu().numpy()

    p = np.stack(rows, axis=0)  # [R, C, 4] in (log m00, log m11, m02, m20)
    table = np.concatenate(
        [np.exp(p[..., :2]), p[..., 2:]], axis=-1).astype(np.float32)
    if save_path:
        os.makedirs(os.path.dirname(save_path), exist_ok=True)
        np.savez_compressed(save_path, ggx_ltc=table)
    return table


@functools.lru_cache(maxsize=None)
def get_ggx_ltc_table(device: torch.device) -> torch.Tensor:
    """The shipped 64 × 64 × 4 table on ``device`` (loaded once per
    device)."""
    with np.load(TABLE_PATH) as data:
        return torch.tensor(np.asarray(data["ggx_ltc"], np.float32),
                            device=device)


def ggx_reflection_ltc_coefficients(cos_theta, roughness,
                                    table=None) -> IsotropicLTC:
    """Bilinear lookup of the fitted LTC at (cos θ, roughness), the
    analogue of ``LTC::GGX_reflection_LTC_coefficients``; ``table``
    [R, C, 4] defaults to the shipped one on ``cos_theta``'s device."""
    cos_theta, roughness = torch.broadcast_tensors(
        torch.as_tensor(cos_theta), torch.as_tensor(roughness))
    if table is None:
        table = get_ggx_ltc_table(cos_theta.device)
    r, c = table.shape[0], table.shape[1]
    x = clip(cos_theta, 0.0, 1.0) * (c - 1)
    y = clip(roughness, 0.0, 1.0) * (r - 1)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, c - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, r - 2)
    fx = (x - x0.to(x.dtype))[..., None]
    fy = (y - y0.to(y.dtype))[..., None]
    table = table.to(x.dtype)
    t00, t01 = table[y0, x0], table[y0, x0 + 1]
    t10, t11 = table[y0 + 1, x0], table[y0 + 1, x0 + 1]
    v = ((1 - fy) * ((1 - fx) * t00 + fx * t01)
         + fy * ((1 - fx) * t10 + fx * t11))
    return IsotropicLTC(m00=v[..., 0], m11=v[..., 1],
                        m22=torch.ones_like(v[..., 0]), m02=v[..., 2],
                        m20=v[..., 3])


if __name__ == "__main__":
    import argparse
    import time

    parser = argparse.ArgumentParser(
        description="Fit the GGX LTC table (64 x 64 cells, 200 Nelder-Mead "
                    "iterations a row).")
    parser.add_argument("-o", "--output", default=BUILD_PATH)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    t0 = time.time()
    table = precompute_ggx_ltc(args.output, device=args.device)
    print(f"fitted {table.shape} GGX LTC table in {time.time() - t0:.1f}s "
          f"→ {args.output}")
