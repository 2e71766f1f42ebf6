"""Integer hashes on uint32 values carried in int64 tensors.

Port of ``bifrost3d_tpu/sampling/hashes.py`` (``reverse_bits``,
``van_der_corput``, ``sobol2``, ``laine_karras_hash``,
``cessen_owen_hash``, ``pcg2d``, ``teschner_hash``, ``jenkins_hash``,
``lcg_next``, ``uint_to_unit_float``), bit-exact.

torch has no uint32 ``+``, ``*``, ``>>`` or ``<<`` on the CPU, so every
value here is a uint32 held in an int64 tensor, and each step is masked
back to 32 bits with ``& 0xFFFFFFFF``. A 32×32-bit product can wrap in
int64, but its low 32 bits — the only ones kept — stay exact. The same
code runs on the CPU and on the card.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
UINT_NORMALIZER = 1.0 / 4294967296.0  # 2^-32, exact in float32

_LCG_MULTIPLIER = 1664525
_LCG_INCREMENT = 1013904223


def u32(x, device=None):
    """A tensor of uint32 values as int64 (accepts ints and tensors)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    return torch.as_tensor(x, dtype=torch.int64, device=device) & M32


def uint_to_unit_float(x):
    """uint32 → float32 in [0, 1]: ``float(x) * 2^-32`` as in the reference."""
    return x.to(torch.float32) * UINT_NORMALIZER


def reverse_bits(x):
    """Bit-reversal of uint32."""
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & M32


def van_der_corput(n, scramble):
    """Base-2 radical inverse with XOR scramble → float [0, 1)."""
    return uint_to_unit_float(reverse_bits(u32(n)) ^ u32(scramble))


def sobol2(n, scramble):
    """Second Sobol dimension with XOR scramble → float [0, 1): the
    reference's serial loop (RNG.h sobol2) over the 32 bits of ``n``."""
    n = u32(n)
    scramble = torch.broadcast_to(u32(scramble, n.device), n.shape)
    v = 1 << 31
    for bit in range(32):
        scramble = scramble ^ (((n >> bit) & 1) * v)
        v ^= v >> 1
    return uint_to_unit_float(scramble)


def laine_karras_hash(x, seed):
    """Laine-Karras 2011 hash for fast Owen scrambling."""
    x = (u32(x) + u32(seed)) & M32
    for k in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ ((x * k) & M32)
    return x


def cessen_owen_hash(x, seed):
    """cessen's improved Laine-Karras hash (RNG.h:150-160)."""
    x = x ^ ((x * 0x3D20ADEA) & M32)
    x = (x + seed) & M32
    x = (x * ((seed >> 16) | 1)) & M32
    x = x ^ ((x * 0x05526C56) & M32)
    x = x ^ ((x * 0x53A22864) & M32)
    return x


def pcg2d(x, y):
    """pcg2d hash (Jarzynski et al. 2020): (uint32, uint32) → (uint32, uint32)."""
    x = (x * _LCG_MULTIPLIER + _LCG_INCREMENT) & M32
    y = (y * _LCG_MULTIPLIER + _LCG_INCREMENT) & M32
    x = (x + y * _LCG_MULTIPLIER) & M32
    y = (y + x * _LCG_MULTIPLIER) & M32
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    x = (x + y * _LCG_MULTIPLIER) & M32
    y = (y + x * _LCG_MULTIPLIER) & M32
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    return x, y


def teschner_hash(x, y, z=None):
    """Teschner et al. 2003 spatial hash (RNG.h teschner_hash)."""
    h = ((u32(x) * 73856093) & M32) ^ ((u32(y) * 19349669) & M32)
    if z is not None:
        h = h ^ ((u32(z) * 83492791) & M32)
    return h


def jenkins_hash(x):
    """Jenkins one-at-a-time style avalanche hash (Math/RNG.h jenkins_hash)."""
    x = (x + (x << 10)) & M32
    x = x ^ (x >> 6)
    x = (x + (x << 3)) & M32
    x = x ^ (x >> 11)
    x = (x + (x << 15)) & M32
    return x


def lcg_next(state):
    """One step of the LCG (multiplier 1664525, increment 1013904223) →
    (new state, float32 sample in [0, 1]). SmallPT seeds it with
    ``jenkins_hash(pixel) ^ reverse_bits(frame)``."""
    state = (state * _LCG_MULTIPLIER + _LCG_INCREMENT) & M32
    return state, uint_to_unit_float(state)
