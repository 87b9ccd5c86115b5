"""Weights and inputs made from ``--seed`` on the device, in a few large
calls, for the program and the reference alike.

Weights: one uniform draw and one normal draw for all the leaves of a
configuration (``reference/uno2d.py`` ``leaves`` names them, their shapes
and laws), split and scaled per leaf.  Inputs: Gaussian random fields by
one inverse FFT per batch of fields (``grf``), then the configuration's
task turns them into Darcy coefficient fields and targets, or Navier-Stokes
input windows.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from benchmark.reference import uno2d

SEED_SALT = {"weights": 1, "train": 2, "serve": 3, "order": 4, "sample": 5}


def generator(seed: int, what: str, device) -> torch.Generator:
    """A generator on ``device`` for one use of the run's seed: the same
    seed gives the same draws, and each use its own."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 16 + SEED_SALT[what]) % (2**63))
    return g


def weights(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of ``model``, f32 or complex64, drawn on ``device``."""
    spec = uno2d.leaves(model)
    n_uni = sum(math.prod(s) for _, s, law, _ in spec if law == "uniform")
    n_cn = sum(math.prod(s) for _, s, law, _ in spec if law == "cnormal")
    g = generator(seed, "weights", device)
    uni = torch.rand(n_uni, generator=g, device=device) * 2.0 - 1.0
    cn = torch.randn(2 * n_cn, generator=g, device=device) * math.sqrt(0.5)
    out: Dict[str, torch.Tensor] = {}
    iu = ic = 0
    for name, shape, law, scale in spec:
        n = math.prod(shape)
        if law == "uniform":
            out[name] = (uni[iu : iu + n] * scale).reshape(shape)
            iu += n
        elif law == "cnormal":
            re, im = cn[ic : ic + n], cn[ic + n : ic + 2 * n]
            out[name] = (torch.complex(re, im) * scale).reshape(shape)
            ic += 2 * n
        elif law == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def grf(g: torch.Generator, n: int, s: int, alpha: float, tau: float, device) -> torch.Tensor:
    """(n, s, s) periodic Gaussian random fields with the spectrum
    ``(4 pi^2 |k|^2 + tau^2)^(-alpha / 2)``, each scaled to unit standard
    deviation."""
    k1 = torch.fft.fftfreq(s, d=1.0 / s, device=device)
    k2 = torch.fft.rfftfreq(s, d=1.0 / s, device=device)
    amp = (4 * math.pi**2 * (k1[:, None] ** 2 + k2[None, :] ** 2) + tau**2) ** (-alpha / 2)
    amp[0, 0] = 0.0
    xi = torch.randn((n, s, s // 2 + 1, 2), generator=g, device=device)
    field = torch.fft.irfft2(torch.view_as_complex(xi) * amp, s=(s, s))
    return field / field.std(dim=(1, 2), keepdim=True)


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


def ns_windows(cfg: dict, g: torch.Generator, n: int, device) -> torch.Tensor:
    """``n`` input windows (n, s, s, t_in) of slowly turning vorticity."""
    d, s, t_in = cfg["data"], cfg["grid"], cfg["t_in"]
    a = grf(g, n, s, d["grf_alpha"], d["grf_tau"], device)
    b = grf(g, n, s, d["grf_alpha"], d["grf_tau"], device)
    t = torch.arange(t_in, device=device, dtype=torch.float32) * d["frame_angle"]
    return (a[..., None] * t.cos() + b[..., None] * t.sin()).contiguous()


def serve_inputs(cfg: dict, g: torch.Generator, n: int, device) -> torch.Tensor:
    """What a serving client sends for ``n`` samples of the task."""
    if cfg["task"] == "darcy":
        return darcy_pairs(cfg, g, n, device)[0]
    return ns_windows(cfg, g, n, device)
