"""2-D Navier-Stokes (U-NO's ``ns_uno2d_main.py``): 10 frames of vorticity
in, 40 out, each predicted frame fed back into the input window.  The
program serves the ``make_rollout`` of ``t_f`` steps, as ``cmd_predict``
does; no cell trains it.

Input windows from the seed: two Gaussian random fields turning slowly into
each other (the configuration's ``data`` section and ``assumed`` list say
how).
"""

from __future__ import annotations

import torch

from benchmark import plugins
from benchmark.inputs import grf


def ns_windows(cfg: dict, g: torch.Generator, n: int, device) -> torch.Tensor:
    """``n`` input windows (n, s, s, t_in) of slowly turning vorticity."""
    d, s, t_in = cfg["data"], cfg["grid"], cfg["t_in"]
    a = grf(g, n, s, d["grf_alpha"], d["grf_tau"], device)
    b = grf(g, n, s, d["grf_alpha"], d["grf_tau"], device)
    t = torch.arange(t_in, device=device, dtype=torch.float32) * d["frame_angle"]
    return (a[..., None] * t.cos() + b[..., None] * t.sin()).contiguous()


serve_inputs = ns_windows


def program_serve(model: torch.nn.Module, cfg: dict, device):
    """``cmd_predict``'s rollout of a batch on the card."""
    from uno_tpu_torch.train.ns2d import make_rollout

    t_f = cfg["t_f"]
    rollout = make_rollout(model, t_f)

    def fwd(xb):
        # the rollout needs targets only for its loss: zeros, as cmd_predict passes
        return rollout(xb, torch.zeros(xb.shape[:3] + (t_f,), device=device))[1]

    return fwd


def reference_answer(cfg: dict, p, x, quant=None) -> torch.Tensor:
    return plugins.family(cfg).rollout(cfg["model"], p, x, cfg["t_f"], quant)
