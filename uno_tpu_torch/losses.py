"""Relative Lp loss (port of ``uno_tpu/losses.py``).

Matches the reference ``LpLoss`` (utilities3.py:75-103): per-sample flattened
relative p-norm ``||x - y||_p / ||y||_p``, reduced by mean or sum, computed
in f32 whatever the inputs' dtype.  Trainers use the sum reduction then
divide by the dataset size (train_darcy.py:42,76-77).
"""

from __future__ import annotations

import torch


def relative_lp_loss(
    x: torch.Tensor,
    y: torch.Tensor,
    p: int = 2,
    reduction: str = "sum",
) -> torch.Tensor:
    """x, y: (B, ...) — flattened per sample.  reduction: 'sum'|'mean'|'none'."""
    b = x.shape[0]
    xf = x.reshape(b, -1).float()
    yf = y.reshape(b, -1).float()
    if p == 2:
        diff = (xf - yf).square().sum(dim=1).sqrt()
        norm = yf.square().sum(dim=1).sqrt()
    else:
        diff = (xf - yf).abs().pow(p).sum(dim=1).pow(1.0 / p)
        norm = yf.abs().pow(p).sum(dim=1).pow(1.0 / p)
    rel = diff / norm
    if reduction == "sum":
        return rel.sum()
    if reduction == "mean":
        return rel.mean()
    return rel
