"""``maximum``, ``minimum``, ``clip`` and ``absolute`` with JAX's gradient
at a tie.

``jnp.maximum`` / ``jnp.minimum`` / ``jnp.clip`` give half the gradient to
each side where the operand equals its bound; ``torch.clamp`` and
``clamp_min`` give all of it to the operand. A material parameter sitting
exactly on a bound (roughness 1.0 in the rho tables' hat weights) then
gets another gradient. ``torch.maximum`` / ``torch.minimum`` split as JAX
does, so these helpers are those two with the bound as a 0-d tensor of
the operand's dtype. The bound lives on the CPU: a 0-d CPU tensor enters a
CUDA kernel as a scalar argument, with no copy and no sync. The forward
is the clamp's bit for bit (min and max are exact). ``jnp.abs`` has slope
+1 at 0 where ``torch.abs`` has 0: ``absolute`` keeps JAX's.

Where autograd does not record ``x`` no gradient can reach a tie, so
``clip`` and ``absolute`` are then the one-kernel ``torch.clamp`` and
``torch.abs`` (a forward frame launches what it launched before them).
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _bound(value: float, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype)


def _recorded(x) -> bool:
    return x.requires_grad and torch.is_grad_enabled()


def maximum(x, lo: float):
    """``jnp.maximum(x, lo)``: elementwise max, the gradient split at a tie."""
    return torch.maximum(x, _bound(float(lo), x.dtype))


def minimum(x, hi: float):
    """``jnp.minimum(x, hi)``: elementwise min, the gradient split at a tie."""
    return torch.minimum(x, _bound(float(hi), x.dtype))


def clip(x, lo: float, hi: float):
    """``jnp.clip(x, lo, hi)`` = ``minimum(maximum(x, lo), hi)``."""
    if not _recorded(x):
        return torch.clamp(x, lo, hi)
    return minimum(maximum(x, lo), hi)


def absolute(x):
    """``jnp.abs(x)`` with its slope at 0: +1 (``torch.abs`` gives 0). Where
    autograd records ``x``, -0.0 stays -0.0."""
    if not _recorded(x):
        return torch.abs(x)
    return torch.where(x >= 0, x, -x)
