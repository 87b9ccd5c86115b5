"""The Darcy coefficients' Gaussian random field (port of ``darcy_grf`` in
``uno_tpu/data/grf.py``).

A Neumann-boundary GRF with covariance ``tau^(2 alpha - 2) (-Laplace +
tau^2 I)^(-alpha)``, realised by a KL expansion in the cosine basis: white
noise ``xi`` is scaled per mode and synthesised with an orthonormal DCT-III
matrix on each axis (the equivalent of the reference's MATLAB ``GRF.m`` and
``idct2``).

The draw of ``xi`` and the synthesis are separate: ``darcy_grf`` draws from
an explicit ``torch.Generator``, ``darcy_grf_from_xi`` is deterministic.
The two packages draw the same law from different streams, so they give
different samples for one seed; fed the ``xi`` that ``jax.random.normal``
gives, the synthesis equals ``uno_tpu``'s.  The periodic ``GaussianRF`` of
the NS generator comes with the NS slice (ROADMAP.md Queue 1 item 6).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def _idct2_matrix(s: int) -> np.ndarray:
    """Orthonormal inverse DCT-II (i.e. DCT-III) synthesis matrix: matches
    MATLAB idct2 applied separably."""
    n = np.arange(s)[:, None]
    k = np.arange(s)[None, :]
    m = np.cos(np.pi * (2 * n + 1) * k / (2 * s)) * math.sqrt(2.0 / s)
    m[:, 0] = math.sqrt(1.0 / s)
    return m.astype(np.float32)


def darcy_grf_from_xi(xi: torch.Tensor, alpha: float = 2.0, tau: float = 3.0) -> torch.Tensor:
    """(n, s, s) GRF samples from standard-normal ``xi`` of the same shape,
    in f32 on ``xi``'s device (TF32 off on a card for full f32)."""
    s = xi.shape[-1]
    k1 = np.arange(s)
    k2sum = k1[:, None] ** 2 + k1[None, :] ** 2
    coef = tau ** (alpha - 1) * (np.pi**2 * k2sum + tau**2) ** (-alpha / 2)
    coef = torch.as_tensor(coef, dtype=torch.float32, device=xi.device)
    big_l = s * coef * xi.float()
    big_l[:, 0, 0] = 0.0
    m = torch.from_numpy(_idct2_matrix(s)).to(xi.device)
    return torch.einsum("ij,njk,lk->nil", m, big_l, m)


def darcy_grf(generator: torch.Generator, n: int, s: int, alpha: float = 2.0,
              tau: float = 3.0, device=None) -> torch.Tensor:
    """(n, s, s) samples of the Neumann GRF used for Darcy coefficients:
    ``xi`` drawn from ``generator`` on its own device, the synthesis on
    ``device`` (default: the generator's)."""
    xi = torch.randn((n, s, s), generator=generator, device=generator.device)
    return darcy_grf_from_xi(xi.to(device or generator.device), alpha, tau)
