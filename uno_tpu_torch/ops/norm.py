"""Normalisation primitives (port of ``uno_tpu/ops/norm.py``).

Instance norm matching ``torch.nn.InstanceNorm{1,2,3}d(affine=True)`` as used
by the reference ``OperatorBlock_{1,2,3}D``: per-(sample, channel)
statistics over the spatial axes, eps=1e-5, biased variance, no running
stats.
"""

from __future__ import annotations

import torch


def instance_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """x: (B, C, *spatial); scale/bias: (C,).  Statistics in f32, output in
    the input's dtype."""
    spatial = tuple(range(2, x.ndim))
    xf = x.float()
    mean = xf.mean(dim=spatial, keepdim=True)
    var = (xf - mean).square().mean(dim=spatial, keepdim=True)
    inv = torch.rsqrt(var + eps)
    shape = (1, -1) + (1,) * len(spatial)
    out = (xf - mean) * inv * scale.reshape(shape) + bias.reshape(shape)
    return out.to(x.dtype)
