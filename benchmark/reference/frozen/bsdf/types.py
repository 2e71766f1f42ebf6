"""BSDF sample and response records.

Port of ``bifrost3d_tpu/bsdf/types.py`` (``BSDFResponse``, ``BSDFSample``,
``invalidate``):
a PDF is a plain value plus an explicit ``is_delta`` mask, and an invalid
sample has ``pdf <= 0``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class BSDFResponse(NamedTuple):
    """evaluate_with_pdf result: reflectance f [..., 3], pdf [...]."""

    reflectance: torch.Tensor
    pdf: torch.Tensor


class BSDFSample(NamedTuple):
    """sample() result: direction wi [..., 3], pdf, delta mask, f [..., 3].

    For delta lobes ``reflectance`` already includes the 1/|cos| factor and
    ``pdf`` holds the discrete lobe-selection probability.
    """

    direction: torch.Tensor
    pdf: torch.Tensor
    is_delta: torch.Tensor
    reflectance: torch.Tensor


def invalidate(sample: BSDFSample, bad_mask) -> BSDFSample:
    """Zero out pdf and reflectance where ``bad_mask``: a branch-free
    discard."""
    return BSDFSample(
        direction=sample.direction,
        pdf=torch.where(bad_mask, 0.0, sample.pdf),
        is_delta=sample.is_delta & ~bad_mask,
        reflectance=torch.where(bad_mask[..., None], 0.0, sample.reflectance))
