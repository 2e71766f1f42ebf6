"""Standalone dev analysis tools — counterparts of the reference's
``apps/dev/{MonteCarloSeeding, NormalRepresentations,
SubsurfaceScatteringTestBed}``.

Port of ``bifrost3d_tpu/apps/dev_analysis.py``: three comparative
analyses, each batched over tensors on the device and printing a compact
table:

- ``seeding`` — Monte-Carlo seeding strategies (MonteCarloSeeding
  main.cpp:218-254): per-pixel estimator error and neighbour correlation
  for jenkins-hash / uniform / morton / sobol-encoded seeds driving an LCG;
- ``normals`` — unit-vector encodings (NormalRepresentations
  main.cpp:187-199): mean / max angular error over random directions;
- ``sss`` — Burley normalized-diffusion sampling
  (SubsurfaceScatteringTestBed): the exact-CDF and the approximate
  samplers against the analytic profile (mean radius, 95th percentile,
  the profile's integral).

Run: ``python -m bifrost3d_tpu_torch.apps.dev_analysis
[seeding|normals|sss|all] [--device cuda|cpu]`` (the card by default).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from bifrost3d_tpu_torch.math.morton import morton_encode_2d
from bifrost3d_tpu_torch.sampling.hashes import (
    M32,
    jenkins_hash,
    lcg_next,
    reverse_bits,
)


# ---------------------------------------------------------------------------
# Monte-Carlo seeding (MonteCarloSeeding/main.cpp)
# ---------------------------------------------------------------------------

def _seed_strategies(width):
    """Each strategy (x, y, s) → uint32 seeds (in int64 tensors)."""
    def jenkins(x, y, s):
        return (jenkins_hash((x + y * width) & M32) + reverse_bits(s)) & M32

    def uniform(x, y, s):
        return torch.broadcast_to(reverse_bits(s), x.shape)

    def morton(x, y, s):
        e = reverse_bits(morton_encode_2d(x, y))
        return (e ^ (e >> 16)) ^ ((1013904223 * s) & M32)

    def sobol_enc(x, y, s):
        # The integer sobol2 (RNG.h sobol2): the float API would drop the
        # low mantissa bits the morton interleave depends on.
        scramble = torch.zeros_like(x)
        v = 1 << 31
        for bit in range(32):
            scramble = scramble ^ (((x >> bit) & 1) * v)
            v ^= v >> 1
        e = reverse_bits(morton_encode_2d(scramble, y))
        return ((e ^ (e >> 16)) + reverse_bits(s)) & M32

    return {"jenkins": jenkins, "uniform": uniform, "morton": morton,
            "sobol-encoded": sobol_enc}


def seeding_analysis(width=128, height=128, sample_count=5, *, device):
    """Estimate ∫₀¹ u du = 0.5 per pixel with ``sample_count`` LCG draws
    seeded per strategy; report the error's standard deviation (estimator
    quality) and the horizontal neighbour correlation of the error image
    (negative = blue-noise-like; ~0 = white noise)."""
    y, x = torch.meshgrid(torch.arange(height, device=device),
                          torch.arange(width, device=device), indexing="ij")
    rows = []
    for name, seeder in _seed_strategies(width).items():
        acc = torch.zeros((height, width), device=device)
        for s in range(sample_count):
            state = seeder(x, y, torch.tensor(s, device=device))
            state, u = lcg_next(state)
            acc = acc + u
        err = (acc / sample_count - 0.5).cpu().numpy()
        a = err[:, :-1].reshape(-1)
        b = err[:, 1:].reshape(-1)
        corr = float(np.corrcoef(a, b)[0, 1])
        rows.append((name, float(err.std()), corr))
    print(f"seeding (∫u du estimator, {sample_count} spp, "
          f"{width}x{height}):")
    print(f"  {'strategy':15s} {'error std':>10s} {'neighbor corr':>14s}")
    for name, std, corr in rows:
        print(f"  {name:15s} {std:10.4f} {corr:14.4f}")
    return {name: dict(error_std=std, neighbor_corr=corr)
            for name, std, corr in rows}


# ---------------------------------------------------------------------------
# Unit-vector encodings (NormalRepresentations/main.cpp)
# ---------------------------------------------------------------------------

def _random_directions(n, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def normals_analysis(n=200_000, *, device):
    """Mean / max angular error (degrees) of unit-vector encodings."""
    from bifrost3d_tpu_torch.math.octahedral import (
        octahedral_decode, octahedral_encode)

    dirs = torch.tensor(_random_directions(n), device=device)

    def angular_error(decoded):
        d = torch.clamp(torch.sum(dirs * decoded, dim=-1), -1.0, 1.0)
        return np.degrees(torch.arccos(d).cpu().numpy())

    def renorm(v):
        return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)

    encodings = {
        "oct32 (2x int16)": lambda: octahedral_decode(
            octahedral_encode(dirs)),
        "half3": lambda: renorm(dirs.half().float()),
        "reconstruct-z64": lambda: torch.cat([
            dirs[:, :2],
            torch.sign(dirs[:, 2:3]) * torch.sqrt(torch.clamp_min(
                1.0 - torch.sum(dirs[:, :2] ** 2, -1, keepdim=True), 0.0))],
            dim=-1),
        "xyz24 (3x unorm8)": lambda: renorm(
            (torch.round((dirs * 0.5 + 0.5) * 255.0) / 255.0 - 0.5) * 2.0),
    }
    print(f"unit-vector encodings ({n} random directions):")
    print(f"  {'encoding':20s} {'mean err°':>10s} {'max err°':>10s}")
    out = {}
    for name, fn in encodings.items():
        err = angular_error(fn())
        print(f"  {name:20s} {err.mean():10.5f} {err.max():10.5f}")
        out[name] = dict(mean_deg=float(err.mean()), max_deg=float(err.max()))
    return out


# ---------------------------------------------------------------------------
# Burley SSS sampling testbed (SubsurfaceScatteringTestBed)
# ---------------------------------------------------------------------------

def sss_analysis(n=1 << 18, dmfp=1.0, *, device):
    """Exact-CDF vs approximate Burley diffusion sampling: the moments of
    each sampler's radii and the analytic profile's polar integral (mean
    radius 11d/8 for the two-exponential profile with s-scaled d)."""
    from bifrost3d_tpu_torch.bsdf.burley_sss import (
        evaluate_profile,
        sample_diffusion_profile,
        sample_diffusion_profile_approximation,
    )

    u = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / n
    d = torch.tensor(dmfp, dtype=torch.float32, device=device)
    out = {}
    print(f"burley SSS sampling (dmfp {dmfp}, {n} stratified samples):")
    print(f"  {'sampler':14s} {'mean r':>9s} {'p95 r':>9s} "
          f"{'pdf·r integ':>12s}")
    for name, fn in (("exact-cdf", sample_diffusion_profile),
                     ("approx-c2.6",
                      sample_diffusion_profile_approximation)):
        res = fn(u, d)
        r = (res[0] if isinstance(res, tuple) else res).cpu().numpy()
        # The polar profile's normalization: ∫ 2πr·R(r) dr should be 1.
        grid = torch.linspace(1e-4, 30.0 * dmfp, 8192, device=device)
        prof = evaluate_profile(grid, d).cpu().numpy()
        grid = grid.cpu().numpy()
        integ = float(np.trapezoid(2.0 * np.pi * grid * prof, grid))
        print(f"  {name:14s} {r.mean():9.4f} {np.percentile(r, 95):9.4f} "
              f"{integ:12.5f}")
        out[name] = dict(mean_r=float(r.mean()),
                         p95_r=float(np.percentile(r, 95)),
                         profile_integral=integ)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("which", nargs="?", default="all",
                        choices=("seeding", "normals", "sss", "all"))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    out = {}
    if args.which in ("seeding", "all"):
        out["seeding"] = seeding_analysis(device=device)
    if args.which in ("normals", "all"):
        out["normals"] = normals_analysis(device=device)
    if args.which in ("sss", "all"):
        out["sss"] = sss_analysis(device=device)
    return out


if __name__ == "__main__":
    main()
