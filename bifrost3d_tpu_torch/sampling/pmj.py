"""Progressive multi-jittered blue-noise sample sequences.

Port of ``bifrost3d_tpu/sampling/pmj.py`` (``pmj02_bn_samples``), which is
numpy only there too: the PMJ-with-blue-noise construction of Christensen
et al. 2018 ("Progressive Multi-Jittered Sample Sequences", supplemental),
the counterpart of the reference's ``Math/RNG.cpp
fill_progressive_multijittered_bluenoise_samples``. The environment light's
presampled pool draws its randoms from it. The construction is serial (each
sample depends on all before it), runs once at scene build on the host from
a fixed seed, and gives the JAX package's sequence bit for bit.

The construction is O(n * candidates) Python-loop work (about 17 s for
8,192 samples), so a sequence is kept in memory for the process and on disk
under ``build/pmj/`` at the repository root. A file there is used only if
its first samples equal a fresh construction's (the sequence is
progressive: a shorter one is a prefix of a longer one).
"""

from __future__ import annotations

import functools
import os
import warnings

import numpy as np

_FREE = -1
# Samples of a cached file that are constructed anew to check it.
_CHECKED_PREFIX = 64

_DISK_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "pmj")


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@functools.lru_cache(maxsize=8)
def _cached(count: int, blue_noise_candidates: int, seed: int) -> np.ndarray:
    out = _generate(count, blue_noise_candidates, seed)
    out.setflags(write=False)
    return out


def pmj02_bn_samples(count: int, blue_noise_candidates: int = 8,
                     seed: int = 19349669) -> np.ndarray:
    """``count`` progressive multi-jittered 2D samples in [0,1)^2 →
    float32 [count, 2] (read-only: the array is shared by later calls)."""
    return _cached(int(count), int(blue_noise_candidates), int(seed))


def _generate(count: int, blue_noise_candidates: int,
              seed: int) -> np.ndarray:
    """The sequence from ``build/pmj/`` if a file there holds it, else
    constructed and written there."""
    cache_path = os.path.join(
        _DISK_CACHE_DIR,
        f"pmj02bn_{count}_{blue_noise_candidates}_{seed}.npy")
    if os.path.exists(cache_path):
        try:
            cached = np.load(cache_path)
        except (OSError, ValueError) as err:
            warnings.warn(f"{cache_path} is unreadable ({err}); the "
                          "sequence is constructed anew")
        else:
            k = min(count, _CHECKED_PREFIX)
            if (cached.shape == (count, 2) and cached.dtype == np.float32
                    and np.array_equal(cached[:k], _construct(
                        k, blue_noise_candidates, seed))):
                return cached
            warnings.warn(f"{cache_path} does not hold this sequence; it is "
                          "constructed anew")
    out = _construct(count, blue_noise_candidates, seed)
    try:
        os.makedirs(_DISK_CACHE_DIR, exist_ok=True)
        tmp = cache_path[:-4] + f".tmp{os.getpid()}.npy"
        np.save(tmp, out)
        os.replace(tmp, cache_path)   # atomic: safe under parallel readers
    except OSError as err:
        warnings.warn(f"the PMJ sequence could not be kept in {cache_path} "
                      f"({err}); every process will construct it again")
    return out


def _construct(count: int, blue_noise_candidates: int,
               seed: int) -> np.ndarray:
    """Generate ``count`` progressive multi-jittered 2D samples in [0,1)^2.

    Each prefix of length 4^k is stratified on the 2^k x 2^k grid and every
    prefix of length n occupies n distinct 1D strata in both x and y. Among
    ``blue_noise_candidates`` candidates the one farthest (toroidally) from
    its nearest neighbour is kept, giving the blue-noise character.

    Returns float32 array [count, 2].
    """
    rng = np.random.default_rng(seed)
    samples = np.zeros((count, 2), np.float64)
    n_storage = _next_pow2(count)
    # Index of the sample occupying each 1D stratum, per axis.
    strata = np.full((2, n_storage), _FREE, np.int64)
    num = 0

    def mark_strata(prev_count: int) -> None:
        next_count = 2 * prev_count
        strata[:, :next_count] = _FREE
        idx = (next_count * samples[:prev_count]).astype(np.int64)
        strata[0, idx[:, 0]] = np.arange(prev_count)
        strata[1, idx[:, 1]] = np.arange(prev_count)

    def candidate_coord(axis: int, cell: int, half: int, grid: int,
                        next_count: int) -> float:
        # Rejection-sample a coordinate in the target subcell whose 1D
        # stratum at resolution next_count is still free.
        while True:
            c = (cell + 0.5 * (half + rng.random())) / grid
            if strata[axis, int(next_count * c)] == _FREE:
                return c

    def min_toroidal_dist2(pt: np.ndarray) -> float:
        if num == 0:
            return np.inf
        d = np.abs(samples[:num] - pt)
        d = np.minimum(d, 1.0 - d)  # repeating-pattern (toroidal) distance
        return float(np.min(np.sum(d * d, axis=1)))

    def place(old_pt: np.ndarray, i: int, j: int, xhalf: int, yhalf: int,
              grid: int, prev_count: int) -> None:
        nonlocal num
        next_count = 2 * prev_count
        best_pt, best_d = None, -1.0
        for _ in range(max(1, blue_noise_candidates)):
            pt = np.array([
                candidate_coord(0, i, xhalf, grid, next_count),
                candidate_coord(1, j, yhalf, grid, next_count)])
            d = min(float(np.sum((old_pt - pt) ** 2)), min_toroidal_dist2(pt))
            if d > best_d:
                best_d, best_pt = d, pt
        strata[0, int(next_count * best_pt[0])] = num
        strata[1, int(next_count * best_pt[1])] = num
        samples[num] = best_pt
        num += 1

    def subquadrant(pt: np.ndarray, grid: int):
        i, j = int(grid * pt[0]), int(grid * pt[1])
        xh = int(2 * (grid * pt[0] - i))
        yh = int(2 * (grid * pt[1] - j))
        return i, j, xh, yh

    def extend_even(prev_count: int) -> None:
        grid = int(round(np.sqrt(prev_count)))
        mark_strata(prev_count)
        for s in range(prev_count):
            if num >= count:
                return
            pt = samples[s]
            i, j, xh, yh = subquadrant(pt, grid)
            place(pt, i, j, 1 - xh, 1 - yh, grid, prev_count)

    def extend_odd(prev_count: int) -> None:
        grid = int(round(np.sqrt(prev_count / 2)))
        mark_strata(prev_count)
        # First half: pick one of the two remaining subquadrants at random.
        chosen = []
        for s in range(prev_count // 2):
            if num >= count:
                return
            pt = samples[s]
            i, j, xh, yh = subquadrant(pt, grid)
            if rng.random() > 0.5:
                xh = 1 - xh
            else:
                yh = 1 - yh
            chosen.append((xh, yh))
            place(pt, i, j, xh, yh, grid, prev_count)
        # Second half: fill the subquadrant diagonally opposite the one above.
        for s in range(prev_count // 2):
            if num >= count:
                return
            pt = samples[s + prev_count]
            i, j, xh, yh = subquadrant(pt, grid)
            place(pt, i, j, 1 - xh, 1 - yh, grid, prev_count)

    samples[0] = rng.random(2)
    num = 1
    current = 1
    while num < count:
        extend_even(current)
        if 2 * current < count:
            extend_odd(2 * current)
        current *= 4

    return samples[:count].astype(np.float32)
