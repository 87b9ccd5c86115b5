"""Relative Lp loss (port of ``uno_tpu/losses.py``).

Matches the reference ``LpLoss`` (utilities3.py:75-103): per-sample flattened
relative p-norm ``||x - y||_p / ||y||_p``, reduced by mean or sum, computed
in f32 whatever the inputs' dtype.  Trainers use the sum reduction then
divide by the dataset size (train_darcy.py:42,76-77).
"""

from __future__ import annotations

import torch

from uno_tpu_torch.parallel.spatial import psum


def relative_lp_loss(
    x: torch.Tensor,
    y: torch.Tensor,
    p: int = 2,
    reduction: str = "sum",
    group=None,
) -> torch.Tensor:
    """x, y: (B, ...) — flattened per sample.  reduction: 'sum'|'mean'|'none'.
    Computed in f32 (float64 for float64 inputs).  With ``group``, x and y
    hold this rank's part of each sample (its rows of a split grid): the
    per-sample sums are all-reduced over the group before the roots, so
    every rank gets the whole loss (``parallel/spatial.py`` counts it once)."""
    b = x.shape[0]
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.reshape(b, -1).to(dt)
    yf = y.reshape(b, -1).to(dt)
    if p == 2:
        diff, norm = (xf - yf).square().sum(dim=1), yf.square().sum(dim=1)
    else:
        diff, norm = (xf - yf).abs().pow(p).sum(dim=1), yf.abs().pow(p).sum(dim=1)
    if group is not None:
        diff, norm = psum(torch.stack([diff, norm]), group)
    if p == 2:
        diff, norm = diff.sqrt(), norm.sqrt()
    else:
        diff, norm = diff.pow(1.0 / p), norm.pow(1.0 / p)
    rel = diff / norm
    if reduction == "sum":
        return rel.sum()
    if reduction == "mean":
        return rel.mean()
    return rel
