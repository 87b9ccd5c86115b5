"""Gaussian random field samplers (port of ``uno_tpu/data/grf.py``).

* ``GaussianRF`` — the NS generator's periodic GRF with spectrum
  ``sigma (4 pi^2 |k|^2 + tau^2)^(-alpha/2)`` in 1, 2 or 3 dimensions,
  sampled by scaling complex white noise and an inverse FFT (the reference's
  ``random_fields-2.py:8-99``).  ``sample`` draws the noise from an explicit
  ``torch.Generator``; ``sample_from_noise`` is the deterministic rest.
* ``darcy_grf`` — the Darcy coefficients' field.

``darcy_grf`` is a Neumann-boundary GRF with covariance ``tau^(2 alpha - 2) (-Laplace +
tau^2 I)^(-alpha)``, realised by a KL expansion in the cosine basis: white
noise ``xi`` is scaled per mode and synthesised with an orthonormal DCT-III
matrix on each axis (the equivalent of the reference's MATLAB ``GRF.m`` and
``idct2``).

The draw of ``xi`` and the synthesis are separate: ``darcy_grf`` draws from
an explicit ``torch.Generator``, ``darcy_grf_from_xi`` is deterministic.
The two packages draw the same law from different streams, so they give
different samples for one seed; fed the ``xi`` that ``jax.random.normal``
gives, the synthesis equals ``uno_tpu``'s.  The same holds for
``GaussianRF``: fed the real and imaginary noise that ``uno_tpu`` draws
(``jax.random.normal`` of the two halves of ``split(key)``),
``sample_from_noise`` gives ``uno_tpu``'s sample.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


def _wavenumbers(size: int) -> np.ndarray:
    k_max = size // 2
    return np.concatenate([np.arange(0, k_max), np.arange(-k_max, 0)])


class GaussianRF:
    """Periodic GRF on a ``size``-point grid per axis, in ``dim`` dimensions."""

    def __init__(self, dim: int, size: int, alpha: float = 2.0, tau: float = 3.0,
                 sigma: float | None = None):
        self.dim = dim
        self.size = size
        if sigma is None:
            sigma = tau ** (0.5 * (2 * alpha - dim))
        k = _wavenumbers(size)
        if dim == 1:
            k2 = k**2
        elif dim == 2:
            k2 = k[:, None] ** 2 + k[None, :] ** 2
        elif dim == 3:
            k2 = k[:, None, None] ** 2 + k[None, :, None] ** 2 + k[None, None, :] ** 2
        else:
            raise ValueError(dim)
        sqrt_eig = ((size**dim) * math.sqrt(2.0) * sigma
                    * (4.0 * math.pi**2 * k2 + tau**2) ** (-alpha / 2.0))
        sqrt_eig.flat[0] = 0.0
        self.sqrt_eig = sqrt_eig.astype(np.float32)

    def sample(self, generator: torch.Generator, n: int, device=None) -> torch.Tensor:
        """(n, size, ..., size) f32 samples: the real and imaginary noise
        drawn from ``generator`` on its own device, the rest on ``device``
        (default: the generator's)."""
        shape = (n,) + (self.size,) * self.dim
        dev = device or generator.device
        re = torch.randn(shape, generator=generator, device=generator.device)
        im = torch.randn(shape, generator=generator, device=generator.device)
        return self.sample_from_noise(re.to(dev), im.to(dev))

    def sample_from_noise(self, re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
        """The samples whose standard-normal noise is ``re + i im`` (each
        (n, size, ..., size)), on their device: the noise scaled per mode in
        complex64, then the real part of its inverse FFT."""
        sqrt_eig = torch.from_numpy(self.sqrt_eig).to(re.device)
        coeff = sqrt_eig * torch.complex(re.float(), im.float())
        return torch.fft.ifftn(coeff, dim=tuple(range(1, self.dim + 1))).real.contiguous()


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
