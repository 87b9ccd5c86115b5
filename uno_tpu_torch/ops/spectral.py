"""Spectral (Fourier) integral operators: the FFT path of
``uno_tpu/ops/spectral.py``.

Behavioural contract, as in ``uno_tpu``:

* ``norm="forward"`` on both FFT directions, so zero-padding / truncation in
  the Fourier domain acts as value-preserving trigonometric interpolation.
* Only the low-|k| corner blocks of the rfft2 spectrum are multiplied by
  learned complex weights; the rest of the output spectrum is zero, sized by
  the requested output grid, so the same layer resamples the domain.
* The transforms run in f32 whatever the input dtype, and the output is f32.

The per-mode complex contraction goes through the CUDA kernels of
``ops/kernels/cmul.py`` (forward and both gradients).  Everything around it
is differentiated by torch autograd: ``rfft2``/``irfft2``, the corner
gather and the slice writes into the output spectrum, where a positive-kx
row that the negative-kx block overwrites gets a zero gradient, as
``uno_tpu``'s ``_unslice_pm`` gives it on the DFT path.  The partial-DFT
transform path (``uno_tpu``'s ``ops/dft.py``) is not ported yet.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from uno_tpu_torch.ops.kernels.cmul import cmul


def spectral_weight_init(
    in_codim: int,
    out_codim: int,
    mode_shape: Sequence[int],
    n_blocks: int,
    generator: torch.Generator = None,
    device=None,
) -> torch.Tensor:
    """Stacked corner-block weights ``(n_blocks, in_codim, out_codim,
    *mode_shape)`` complex64: ``scale * complex-normal`` with re and im each
    drawn from N(0, 1/2) and ``scale = (1/(2*in_codim))**0.5``, the
    distribution of ``uno_tpu``'s ``spectral_weight_init``.  Drawn on the
    CPU from ``generator``, then moved to ``device``."""
    scale = (1.0 / (2.0 * in_codim)) ** 0.5
    shape = (n_blocks, in_codim, out_codim, *mode_shape)
    half = math.sqrt(0.5)
    re = torch.randn(shape, generator=generator) * half
    im = torch.randn(shape, generator=generator) * half
    return (scale * torch.complex(re, im)).to(device)


def complex_mode_matmul(x_ft: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum('bi...,io...->bo...')`` on complex64 inputs.

    x_ft: (B, Ci, *modes); w: (Ci, Co, *modes).  The mode axes are flattened
    into M for the kernel's (B, Ci, M) x (Ci, Co, M) layout.
    """
    b, ci = x_ft.shape[:2]
    co = w.shape[1]
    mode_shape = x_ft.shape[2:]
    out = cmul(x_ft.reshape(b, ci, -1), w.reshape(ci, co, -1))
    return out.reshape(b, co, *mode_shape)


def spectral_conv_2d(
    x: torch.Tensor,
    weights: torch.Tensor,
    out_size: Tuple[int, int],
    modes: Tuple[int, int],
) -> torch.Tensor:
    """2D spectral conv.  x: (B, Ci, H, W) real -> (B, Co, d1, d2) f32.

    weights: (2, Ci, Co, m1, m2) complex64 — block 0 multiplies the
    ``[:m1, :m2]`` (non-negative kx) corner, block 1 the ``[-m1:, :m2]``
    (negative kx) corner of the rfft2 spectrum.
    """
    d1, d2 = out_size
    m1, m2 = modes
    h, w_in = x.shape[-2:]
    if m1 > d1 or m1 > h or m2 > d2 // 2 + 1 or m2 > w_in // 2 + 1:
        raise ValueError(f"modes {modes} incompatible with in {tuple(x.shape)} out {out_size}")

    w = torch.cat([weights[0], weights[1]], dim=2)  # (Ci, Co, 2*m1, m2)
    x_ft = torch.fft.rfft2(x.float(), norm="forward")
    corners = torch.cat([x_ft[:, :, :m1, :m2], x_ft[:, :, h - m1 :, :m2]], dim=2)
    out = complex_mode_matmul(corners, w)  # (B, Co, 2*m1, m2)

    # Zero-embed the corner rows in the output spectrum.  When 2*m1 > d1 the
    # reference's corner writes overlap and the negative-kx block (written
    # last) wins, so only the first d1-m1 rows of the positive block survive.
    b, co = out.shape[:2]
    n_top = min(m1, d1 - m1)
    out_ft = torch.zeros((b, co, d1, d2 // 2 + 1), dtype=out.dtype, device=out.device)
    out_ft[:, :, :n_top, :m2] = out[:, :, :n_top]
    out_ft[:, :, d1 - m1 :, :m2] = out[:, :, m1:]
    return torch.fft.irfft2(out_ft, s=(d1, d2), norm="forward")
