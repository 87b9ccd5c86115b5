"""Positional (grid) embeddings concatenated on the channel axis before the
lift (port of ``uno_tpu/models/embeddings.py``).

* Darcy: raw ``(x, y) ∈ [0,1]^2`` linspace grid
* NS 2D: ``(sin x, sin y, cos x, cos y)`` with x, y ∈ linspace(0, 2π)
* NS 3D: the four NS-2D channels plus linear time ``z ∈ [0,1]``

``linspace`` includes both endpoints.  Outputs are channels-last f32.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def _axes(shape: Tuple[int, ...], end: float, device, rows=None):
    """The two planar coordinates over the global ``shape``'s first two grid
    axes, keeping ``rows`` (lo, hi) of the first when given (a rank's rows
    of a split grid)."""
    b, s1, s2 = shape[0], shape[1], shape[2]
    lo, hi = rows if rows is not None else (0, s1)
    gx = torch.linspace(0.0, end, s1, dtype=torch.float32, device=device)[lo:hi]
    gy = torch.linspace(0.0, end, s2, dtype=torch.float32, device=device)
    gx = gx[None, :, None, None].expand(b, hi - lo, s2, 1)
    gy = gy[None, None, :, None].expand(b, hi - lo, s2, 1)
    return gx, gy


def grid_linear_2d(shape: Tuple[int, ...], device=None, rows=None) -> torch.Tensor:
    """(B, S1, S2, 2) raw [0,1] coordinates (``rows`` of S1 only, if given)."""
    gx, gy = _axes(shape, 1.0, device, rows)
    return torch.cat([gx, gy], dim=-1)


def grid_sincos_2d(shape: Tuple[int, ...], device=None, rows=None) -> torch.Tensor:
    """(B, S1, S2, 4): sin/cos of linspace(0, 2π) per axis."""
    gx, gy = _axes(shape, 2.0 * math.pi, device, rows)
    return torch.cat([gx.sin(), gy.sin(), gx.cos(), gy.cos()], dim=-1)


def grid_sincos_3d(shape: Tuple[int, ...], device=None, rows=None) -> torch.Tensor:
    """(B, S1, S2, T, 5): sin x, sin y, cos x, cos y, z ∈ [0, 1]."""
    b, t = shape[0], shape[3]
    gx, gy = _axes(shape, 2.0 * math.pi, device, rows)
    s1, s2 = gx.shape[1], gx.shape[2]
    gz = torch.linspace(0.0, 1.0, t, dtype=torch.float32, device=device)
    planar = torch.cat([gx.sin(), gy.sin(), gx.cos(), gy.cos()], dim=-1)
    return torch.cat([planar[:, :, :, None].expand(b, s1, s2, t, 4),
                      gz[None, None, None, :, None].expand(b, s1, s2, t, 1)], dim=-1)


EMBEDDINGS = {
    "linear2d": grid_linear_2d,
    "sincos2d": grid_sincos_2d,
    "sincos3d": grid_sincos_3d,
}
