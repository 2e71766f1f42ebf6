"""2D CDF distribution: marginal CDF over rows + conditional CDF per row.

Port of ``bifrost3d_tpu/math/distribution2d.py`` (``_searchsorted_rows``,
``Distribution2D``), the counterpart of the reference's
``Math/Distribution2D.h``, which the environment light samples by
importance.

- marginal CDF ``[h + 1]`` over rows (the v axis), conditional ``[h, w + 1]``.
- ``sample_continuous(u2) -> ((u, v) in [0,1)^2, pdf)`` with
  ``pdf = marginal_pdf * conditional_pdf * w * h``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def _searchsorted_rows(cdf_rows, u):
    """Per-row search: ``cdf_rows`` [..., n+1] row-wise CDFs, ``u`` [...]
    one sample per row → index i with cdf[i] <= u < cdf[i+1] (the count of
    entries <= u, less one: ``right=True``)."""
    i = torch.searchsorted(cdf_rows.contiguous(), u[..., None].contiguous(),
                           right=True)[..., 0] - 1
    return torch.clamp(i, 0, cdf_rows.shape[-1] - 2)


class Distribution2D(NamedTuple):
    marginal_cdf: torch.Tensor     # [h + 1]
    conditional_cdf: torch.Tensor  # [h, w + 1]
    integral: torch.Tensor         # scalar, mean of the function

    @property
    def width(self) -> int:
        return self.conditional_cdf.shape[-1] - 1

    @property
    def height(self) -> int:
        return self.marginal_cdf.shape[-1] - 1

    @staticmethod
    def build(function) -> "Distribution2D":
        """Build from a non-negative function ``[h, w]``, on its device."""
        f = torch.as_tensor(function, dtype=torch.float32)
        h, w = f.shape[-2], f.shape[-1]
        row_sums = torch.sum(f, dim=-1)                      # [h]
        ccdf = torch.cat([f.new_zeros((h, 1)), torch.cumsum(f, dim=-1)],
                         dim=-1)
        safe_rows = torch.where(row_sums > 0, row_sums, 1.0)[..., None]
        uniform_row = torch.arange(w + 1, dtype=f.dtype, device=f.device) / w
        ccdf = torch.where(row_sums[..., None] > 0, ccdf / safe_rows,
                           uniform_row)
        mcdf = torch.cat([f.new_zeros(1), torch.cumsum(row_sums, dim=-1)],
                         dim=-1)
        total = mcdf[-1]
        safe_total = torch.where(total > 0, total, 1.0)
        uniform = torch.arange(h + 1, dtype=f.dtype, device=f.device) / h
        mcdf = torch.where(total > 0, mcdf / safe_total, uniform)
        return Distribution2D(marginal_cdf=mcdf, conditional_cdf=ccdf,
                              integral=total / (w * h))

    def to(self, device) -> "Distribution2D":
        return Distribution2D(*(t.to(device) for t in self))

    def sample_continuous(self, u2):
        """u2: [..., 2] in [0,1)^2 → ((u, v) [..., 2], pdf [...])."""
        w, h = self.width, self.height
        ux, uy = u2[..., 0], u2[..., 1]
        y = torch.clamp(
            torch.searchsorted(self.marginal_cdf, uy.contiguous(),
                               right=True) - 1, 0, h - 1)
        m_lo = self.marginal_cdf[y]
        m_pdf = self.marginal_cdf[y + 1] - m_lo
        dy = torch.where(m_pdf > 0,
                         (uy - m_lo) / torch.where(m_pdf > 0, m_pdf, 1.0), 0.0)

        rows = self.conditional_cdf[y]                      # [..., w+1]
        x = _searchsorted_rows(rows, ux)
        c_lo = torch.gather(rows, -1, x[..., None])[..., 0]
        c_hi = torch.gather(rows, -1, x[..., None] + 1)[..., 0]
        c_pdf = c_hi - c_lo
        dx = torch.where(c_pdf > 0,
                         (ux - c_lo) / torch.where(c_pdf > 0, c_pdf, 1.0), 0.0)

        uv = torch.stack([(x + dx) / w, (y + dy) / h], dim=-1)
        return uv, m_pdf * c_pdf * (w * h)

    def pdf_continuous(self, uv):
        w, h = self.width, self.height
        x = torch.clamp((uv[..., 0] * w).to(torch.int64), 0, w - 1)
        y = torch.clamp((uv[..., 1] * h).to(torch.int64), 0, h - 1)
        m_pdf = self.marginal_cdf[y + 1] - self.marginal_cdf[y]
        rows = self.conditional_cdf[y]
        c_lo = torch.gather(rows, -1, x[..., None])[..., 0]
        c_hi = torch.gather(rows, -1, x[..., None] + 1)[..., 0]
        return m_pdf * (c_hi - c_lo) * (w * h)

    def evaluate(self, uv):
        return self.pdf_continuous(uv) * self.integral
