"""1D CDF distribution over a discretized function.

Port of ``bifrost3d_tpu/math/distribution1d.py`` (``Distribution1D``), the
counterpart of the reference's ``Math/Distribution1D.h``: the CDF is built
with ``torch.cumsum`` and sampled with ``torch.searchsorted``.

- The CDF has ``n + 1`` entries with ``cdf[0] = 0, cdf[n] = 1``.
- ``integral`` is the mean of the function over [0, 1].
- ``sample_continuous(u) -> (x in [0,1), pdf)`` with
  ``pdf = (cdf[i+1] - cdf[i]) * n``.

``jnp.searchsorted(cdf, u, side="right")`` is
``torch.searchsorted(cdf, u, right=True)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Distribution1D(NamedTuple):
    cdf: torch.Tensor       # [n + 1], cdf[0] = 0, cdf[n] = 1
    integral: torch.Tensor  # scalar, mean of the function

    @property
    def element_count(self) -> int:
        return self.cdf.shape[-1] - 1

    @staticmethod
    def build(function) -> "Distribution1D":
        """Build from non-negative function values ``[n]``; a zero function
        becomes the uniform distribution (its integral stays 0)."""
        f = torch.as_tensor(function, dtype=torch.float32)
        n = f.shape[-1]
        cdf = torch.cat([f.new_zeros(f.shape[:-1] + (1,)),
                         torch.cumsum(f, dim=-1)], dim=-1)
        total = cdf[..., -1:]
        safe_total = torch.where(total > 0, total, 1.0)
        uniform = torch.arange(n + 1, dtype=f.dtype, device=f.device) / n
        cdf = torch.where(total > 0, cdf / safe_total, uniform)
        return Distribution1D(cdf=cdf, integral=total[..., 0] / n)

    def pdf_discrete(self, i):
        return self.cdf[i + 1] - self.cdf[i]

    def evaluate(self, x):
        """Function value at continuous x in [0, 1)."""
        n = self.element_count
        i = torch.clamp((x * n).to(torch.int64), 0, n - 1)
        return self.pdf_discrete(i) * n * self.integral

    def sample_discrete(self, u):
        """u in [0,1) → (index, discrete pdf)."""
        i = torch.clamp(
            torch.searchsorted(self.cdf, u.contiguous(), right=True) - 1,
            0, self.element_count - 1)
        return i, self.pdf_discrete(i)

    def sample_continuous(self, u):
        """u in [0,1) → (x in [0,1), continuous pdf)."""
        n = self.element_count
        i, pdf_discrete = self.sample_discrete(u)
        safe = torch.where(pdf_discrete > 0, pdf_discrete, 1.0)
        di = torch.where(pdf_discrete > 0, (u - self.cdf[i]) / safe, 0.0)
        return (i + di) / n, pdf_discrete * n

    def pdf_continuous(self, x):
        n = self.element_count
        i = torch.clamp((x * n).to(torch.int64), 0, n - 1)
        return self.pdf_discrete(i) * n
