"""3-D Navier-Stokes (U-NO's ``ns_uno3d_main.py``): 10 frames of vorticity
in, all 40 frames out of one forward of a space-time U-NO.  The program
trains as ``train_ns3d`` does (the summed full-field relative L2 of
``forecast``; each step's ``step_rel_l2``, taken without gradients after
the optimizer's step, summed over the epoch) and serves ``forecast``.

Trajectories from the seed: 50-frame windows of two Gaussian random fields
turning slowly into each other (``ns2d.ns_windows``; the configuration's
``data`` section and ``assumed`` list say how), the first ``t_in`` frames
the input and the next ``t_f`` the target.
"""

from __future__ import annotations

from typing import Tuple

import torch

from benchmark import plugins
from benchmark.tasks.ns2d import ns_windows

CHUNK = 500  # windows drawn at a time: the split is the card's, not its draws'


def train_split(cfg: dict, g: torch.Generator, n: int, device) -> Tuple[torch.Tensor,
                                                                        torch.Tensor]:
    """``n`` trajectories: inputs (n, s, s, t_in) and targets (n, s, s, t_f),
    drawn a chunk of windows at a time into the two resident tensors."""
    s, t_in, t_f = cfg["grid"], cfg["t_in"], cfg["t_f"]
    whole = dict(cfg, t_in=t_in + t_f)
    x = torch.empty((n, s, s, t_in), device=device)
    y = torch.empty((n, s, s, t_f), device=device)
    for lo in range(0, n, CHUNK):
        w = ns_windows(whole, g, min(CHUNK, n - lo), device)
        x[lo : lo + len(w)] = w[..., :t_in]
        y[lo : lo + len(w)] = w[..., t_in:]
    return x, y


serve_inputs = ns_windows


def program_loss(model: torch.nn.Module, cfg: dict):
    """``train_ns3d``'s loss: the relative L2 of the forecast, summed over
    the batch, with the forecast as what the step logs."""
    from uno_tpu_torch import losses
    from uno_tpu_torch.train.ns3d import forecast

    t_f = cfg["t_f"]

    def loss_fn(x, y):
        out = forecast(model, x, t_f)
        # through the module, so that a planted fault reaches it
        return losses.relative_lp_loss(out, y, reduction="sum"), out

    return loss_fn


def logged(out: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """What ``train_ns3d`` adds to the epoch's sum: each frame's relative L2."""
    from uno_tpu_torch.train.ns3d import step_rel_l2

    return step_rel_l2(out, y)


def program_serve(model: torch.nn.Module, cfg: dict, device):
    """``forecast`` of a batch on the card."""
    from uno_tpu_torch.train.ns3d import forecast

    t_f = cfg["t_f"]
    return lambda xb: forecast(model, xb, t_f)


def reference_answer(cfg: dict, p, x, quant=None) -> torch.Tensor:
    out = plugins.family(cfg).forward(cfg["model"], p, x[..., None], quant)
    return out.reshape(*x.shape[:3], cfg["t_f"])


def reference_loss(cfg: dict, p, x, y, quant=None) -> torch.Tensor:
    return plugins.family(cfg).rel_l2_sum(reference_answer(cfg, p, x, quant), y)
