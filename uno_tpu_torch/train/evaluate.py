"""Evaluation (port of the Darcy part of ``uno_tpu/train/evaluate.py``).

U-NO's blocks size every internal grid as a ratio of the padded input grid,
so trained weights evaluate at any resolution.  The NS-2D, NS-3D and
super-resolution evaluators come with those slices (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import numpy as np
import torch

from uno_tpu_torch.losses import relative_lp_loss


def evaluate_darcy(model: torch.nn.Module, x: np.ndarray, y: np.ndarray,
                   batch_size: int = 8) -> float:
    """Mean relative-L2 of model(x) vs y at whatever resolution x carries,
    on the model's device."""
    n = len(x)
    s = y.shape[1]
    device = next(model.parameters()).device
    total = torch.zeros((), device=device)
    with torch.no_grad():
        for i in range(0, n, batch_size):
            xb = torch.from_numpy(np.ascontiguousarray(x[i : i + batch_size])).to(device)
            yb = torch.from_numpy(np.ascontiguousarray(y[i : i + batch_size])).to(device)
            out = model(xb.float()).reshape(xb.shape[0], s, s)
            total += relative_lp_loss(out, yb, reduction="sum")
    return float(total) / n
