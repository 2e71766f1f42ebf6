"""Practical hash-based Owen-scrambled Sobol (Burley 2020), bit-exact.

Port of ``bifrost3d_tpu/sampling/sobol.py`` (``Dimension``,
``sobol_sample_4d_uint``, ``sobol_sample_4d``, ``path_rng_4d``): 4D Sobol
points indexed by (accumulation, pixel hash, dimension), Owen-scrambled
with the cessen hash; per-path dimensions are ``8*bounce + offset``.

The JAX version XOR-reduces 32 direction numbers in an unrolled loop. Here
the XOR over the index's set bits is one float32 matrix product instead:
bit j of an output is the parity of how many selected direction numbers
have bit j set, and those counts (at most 32) are exact in float32. That
keeps the whole chain at a few dozen tensor ops per call, on the card as
on the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from benchmark.reference.frozen.sampling.hashes import (
    M32,
    cessen_owen_hash,
    pcg2d,
    reverse_bits,
    u32,
    uint_to_unit_float,
)


class Dimension:
    """QMC dimension offsets within a bounce (Types.h:422-427)."""

    CAMERA = 0
    NEE = 1
    BSDF = 2
    RR = 3
    PER_BOUNCE = 8


def sobol_direction_numbers() -> np.ndarray:
    """First four dimensions of the standard Sobol direction numbers
    [4, 32] uint32 (dim 0 van der Corput; dims 1-3 from the primitive
    polynomials x+1, x^2+x+1, x^3+x+1 with m = (1), (1,3), (1,3,1))."""
    polys = [None, 0b11, 0b111, 0b1011]
    init_m = [None, [1], [1, 3], [1, 3, 1]]
    v = np.zeros((4, 32), dtype=np.uint64)
    v[0] = [1 << (31 - i) for i in range(32)]
    for d in range(1, 4):
        poly = polys[d]
        s = poly.bit_length() - 1
        m = list(init_m[d])
        for i in range(s, 32):
            mi = m[i - s] ^ (m[i - s] << s)
            for k in range(1, s):
                if (poly >> (s - k)) & 1:
                    mi ^= m[i - k] << k
            m.append(mi)
        for i in range(32):
            v[d, i] = m[i] << (31 - i)
    return v.astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _sobol_tables(device: torch.device):
    """Read-only device constants: the direction numbers as a 0/1 matrix
    [32 index bits, 4·32 output bits] and the 32 bit shifts."""
    dirs = sobol_direction_numbers().astype(np.int64)          # [4, 32]
    bits = (dirs[:, :, None] >> np.arange(32)) & 1             # [4, b, j]
    matrix = np.transpose(bits, (1, 0, 2)).reshape(32, 128)    # [b, 4·j]
    return (torch.as_tensor(matrix, dtype=torch.float32, device=device),
            torch.arange(32, dtype=torch.int64, device=device))


def _nested_uniform_scramble(x, seed):
    """Owen scramble in base 2 via the bit-reversed cessen hash."""
    return reverse_bits(cessen_owen_hash(reverse_bits(x), seed))


def _hash_combine(seed, v: int):
    return seed ^ ((v + (seed << 6) + (seed >> 2)) & M32)


def _sobol_4d_uint(index):
    """Unscrambled 4D Sobol point for uint32 ``index`` [...] → [..., 4]."""
    matrix, shifts = _sobol_tables(index.device)
    bits = ((index[..., None] >> shifts) & 1).to(torch.float32)   # [..., 32]
    counts = (bits @ matrix).to(torch.int64) & 1                   # [..., 128]
    counts = counts.reshape(index.shape + (4, 32))
    return torch.sum(counts << shifts, dim=-1)


def sobol_sample_4d_uint(index, seed):
    """Owen-scrambled 4D Sobol sample → uint32 [..., 4] (in int64)."""
    index, seed = torch.broadcast_tensors(index, seed)
    index = _nested_uniform_scramble(index, seed)
    xs = _sobol_4d_uint(index)
    return torch.stack([
        _nested_uniform_scramble(xs[..., d], _hash_combine(seed, d))
        for d in range(4)], dim=-1)


def sobol_sample_4d(index, seed):
    """Owen-scrambled 4D Sobol sample → float32 [..., 4] in [0, 1]."""
    return uint_to_unit_float(sobol_sample_4d_uint(index, seed))


def path_rng_4d(accumulation_count, pixel_hash, dimension):
    """seed = pcg2d(pixel_hash, dimension).x; → float32 [..., 4].

    ``pixel_hash`` is an int64 tensor of uint32 values;
    ``accumulation_count`` and ``dimension`` are ints or int64 tensors that
    broadcast with it.
    """
    device = pixel_hash.device
    seed, _ = pcg2d(pixel_hash, u32(dimension, device))
    return sobol_sample_4d(u32(accumulation_count, device), seed)
