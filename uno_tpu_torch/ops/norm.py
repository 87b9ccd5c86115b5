"""Normalisation primitives (port of ``uno_tpu/ops/norm.py``).

Instance norm matching ``torch.nn.InstanceNorm{1,2,3}d(affine=True)`` as used
by the reference ``OperatorBlock_{1,2,3}D``: per-(sample, channel)
statistics over the spatial axes, eps=1e-5, biased variance, no running
stats.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from uno_tpu_torch.parallel.spatial import Split, psum


def instance_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5,
    split: Optional[Split] = None,
) -> torch.Tensor:
    """x: (B, C, *spatial); scale/bias: (C,).  Statistics in f32 (float64
    for a float64 x), output in the input's dtype.  With ``split``, x holds
    its rows of axis 2 (``split.n`` long): each pass's sums are all-reduced
    over the ranks before they are divided (mean first, then the variance
    about it, as without the split)."""
    spatial = tuple(range(2, x.ndim))
    xf = x if x.dtype == torch.float64 else x.float()
    if split is None:
        mean = xf.mean(dim=spatial, keepdim=True)
        var = (xf - mean).square().mean(dim=spatial, keepdim=True)
    else:
        count = split.n * math.prod(x.shape[3:])
        mean = psum(xf.sum(dim=spatial, keepdim=True), split.group) / count
        var = psum((xf - mean).square().sum(dim=spatial, keepdim=True),
                             split.group) / count
    inv = torch.rsqrt(var + eps)
    shape = (1, -1) + (1,) * len(spatial)
    out = (xf - mean) * inv * scale.reshape(shape) + bias.reshape(shape)
    return out.to(x.dtype)
