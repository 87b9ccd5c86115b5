"""Evaluation (port of the Darcy, NS-2D and NS-3D parts of
``uno_tpu/train/evaluate.py``).

U-NO's blocks size every internal grid as a ratio of the padded input grid,
so trained weights evaluate at any resolution: ``evaluate_superres`` holds
the same weights to the training grid and to a finer one.
"""

from __future__ import annotations

from typing import Dict

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


def evaluate_superres(model: torch.nn.Module, x_lo: np.ndarray, y_lo: np.ndarray,
                      x_hi: np.ndarray, y_hi: np.ndarray,
                      batch_size: int = 8) -> Dict[str, float]:
    """Same weights at the training grid and at a finer grid: U-NO's
    discretisation-invariance contract (``uno_tpu``'s ``evaluate_superres``)."""
    return {
        "rel_l2_train_res": evaluate_darcy(model, x_lo, y_lo, batch_size),
        "rel_l2_super_res": evaluate_darcy(model, x_hi, y_hi, batch_size),
    }


def evaluate_ns2d(model: torch.nn.Module, a: np.ndarray, u: np.ndarray, t_f: int,
                  batch_size: int = 8) -> Dict[str, float]:
    """Autoregressive rollout metrics on an (a, u) split, on the model's
    device: the per-step and whole-trajectory rel-L2 that the NS-2D trainer
    reports (ns_train_2d.py:74-110, :155-157 semantics, through
    ``train.ns2d.make_rollout``)."""
    from uno_tpu_torch.train.ns2d import make_rollout

    rollout = make_rollout(model, t_f)
    n = len(a)
    device = next(model.parameters()).device
    step_total = torch.zeros((), device=device)
    traj_total = torch.zeros((), device=device)
    with torch.no_grad():
        for i in range(0, n, batch_size):
            xx = torch.from_numpy(np.ascontiguousarray(a[i : i + batch_size])).to(device)
            yy = torch.from_numpy(np.ascontiguousarray(u[i : i + batch_size])).to(device)
            loss, pred = rollout(xx, yy)
            step_total += loss
            traj_total += relative_lp_loss(pred, yy, reduction="sum")
    return {"step_rel_l2": float(step_total) / n / t_f,
            "traj_rel_l2": float(traj_total) / n}


def evaluate_ns3d(model: torch.nn.Module, a: np.ndarray, u: np.ndarray, t_f: int,
                  batch_size: int = 8) -> Dict[str, float]:
    """One-shot spatiotemporal forecast metrics on an (a, u) split, on the
    model's device: the full-field rel-L2 (the training and model-selection
    loss, ns_train_3d.py:64-65), summed and divided by n, and the per-step
    rel-L2 (the reference's logged step loss, :56-62), summed over samples
    and steps and divided by n * T_f."""
    from uno_tpu_torch.train.ns3d import forecast, step_rel_l2

    n = len(a)
    device = next(model.parameters()).device
    full_total = torch.zeros((), device=device)
    step_total = torch.zeros((), device=device)
    with torch.no_grad():
        for i in range(0, n, batch_size):
            xx = torch.from_numpy(np.ascontiguousarray(a[i : i + batch_size])).to(device)
            yy = torch.from_numpy(np.ascontiguousarray(u[i : i + batch_size])).to(device)
            out = forecast(model, xx, t_f)
            full_total += relative_lp_loss(out, yy, reduction="sum")
            step_total += step_rel_l2(out, yy)
    return {"field_rel_l2": float(full_total) / n,
            "step_rel_l2": float(step_total) / (n * t_f)}
