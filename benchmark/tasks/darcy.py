"""Darcy flow (U-NO's ``darcy_flow_main.py``): a permeability field in,
the pressure field out, one forward a sample.  The program trains as
``train_darcy`` and serves as ``cmd_predict`` does.

Data from the seed: coefficient fields of two values from a Gaussian random
field, targets the field smoothed and damped to the boundary (the
configuration's ``data`` section and ``assumed`` list say how).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from benchmark import plugins
from benchmark.inputs import grf


def darcy_pairs(cfg: dict, g: torch.Generator, n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` Darcy samples at the configuration's grid: coefficient fields
    (n, s, s, 1) and targets (n, s, s)."""
    d, s = cfg["data"], cfg["grid"]
    field = grf(g, n, s, d["grf_alpha"], d["grf_tau"], device)
    a = torch.where(field >= 0, d["coeff_high"], d["coeff_low"])
    k1 = torch.fft.fftfreq(s, device=device)
    k2 = torch.fft.rfftfreq(s, device=device)
    sig = d["target_smooth_cells"]
    blur = torch.exp(-2 * math.pi**2 * sig**2 * (k1[:, None] ** 2 + k2[None, :] ** 2))
    smooth = torch.fft.irfft2(torch.fft.rfft2(a) * blur, s=(s, s))
    x = torch.linspace(0.0, 1.0, s, device=device)
    env = torch.sin(math.pi * x)[:, None] * torch.sin(math.pi * x)[None, :]
    y = smooth * env * d["target_scale"]
    return a[..., None].contiguous(), y.contiguous()


train_split = darcy_pairs


def serve_inputs(cfg: dict, g: torch.Generator, n: int, device) -> torch.Tensor:
    return darcy_pairs(cfg, g, n, device)[0]


def program_loss(model: torch.nn.Module, cfg: dict):
    """``train_darcy``'s loss: the relative L2 of the model's output, summed
    over the batch."""
    from uno_tpu_torch import losses

    def loss_fn(x, y):
        # through the module, so that a planted fault reaches it
        return losses.relative_lp_loss(model(x).reshape(y.shape), y, reduction="sum")

    return loss_fn


def program_serve(model: torch.nn.Module, cfg: dict, device):
    """``cmd_predict``'s forward of a batch on the card."""
    s = cfg["grid"]

    def fwd(xb):
        return model(xb.float()).reshape(xb.shape[0], s, s)

    return fwd


def reference_loss(cfg: dict, p, x, y, quant=None) -> torch.Tensor:
    ref = plugins.family(cfg)
    return ref.rel_l2_sum(ref.forward(cfg["model"], p, x, quant), y)


def reference_answer(cfg: dict, p, x, quant=None) -> torch.Tensor:
    s = cfg["grid"]
    return plugins.family(cfg).forward(cfg["model"], p, x, quant).reshape(x.shape[0], s, s)
