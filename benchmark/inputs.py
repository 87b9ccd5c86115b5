"""Weights and inputs made from ``--seed`` on the device, in a few large
calls, for the program and the reference alike.

Weights: one uniform draw and one normal draw for all the leaves of a
configuration (its model family's ``leaves`` names them, their shapes and
laws), split and scaled per leaf.  Inputs: the configuration's task
(``benchmark/tasks/<task>.py``) makes its training split and what a serving
client sends, from Gaussian random fields drawn by one inverse FFT per
batch of fields (``grf``).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark import plugins

SEED_SALT = {"weights": 1, "train": 2, "serve": 3, "order": 4, "sample": 5}


def generator(seed: int, what: str, device) -> torch.Generator:
    """A generator on ``device`` for one use of the run's seed: the same
    seed gives the same draws, and each use its own."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 16 + SEED_SALT[what]) % (2**63))
    return g


def weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of the configuration's model, f32 or complex64, drawn on
    ``device``."""
    spec = plugins.family(cfg).leaves(cfg["model"])
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


def train_split(cfg: dict, g: torch.Generator, n: int, device):
    """``n`` training samples of the configuration's task: (inputs, targets)."""
    return plugins.task(cfg).train_split(cfg, g, n, device)


def serve_inputs(cfg: dict, g: torch.Generator, n: int, device) -> torch.Tensor:
    """What a serving client sends for ``n`` samples of the configuration's task."""
    return plugins.task(cfg).serve_inputs(cfg, g, n, device)
