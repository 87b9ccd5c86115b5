"""Complex mode contraction ``y[b,o,m] = sum_i x[b,i,m] * w[i,o,m]``.

Replaces the TPU kernel ``uno_tpu/ops/pallas/cmul.py: _contract_kernel``
(launched by ``lane_contract``), here in its forward use: the FFT-path
spectral conv contracts the kept Fourier corners of the input against the
spectral weights, one small complex (B x Ci) @ (Ci x Co) product per mode.

On an H100 the contraction is bound by reading the weights (Ci*Co*M complex
values, each used by B multiply-adds); the CUDA kernel in
``uno_tpu_torch/csrc/cmul.cu`` reads each weight once per batch chunk of 8,
with coalesced loads along the mode axis.  See the source for the design.

A tensor on the CPU goes to ``cmul_plain``; a CUDA tensor goes to the kernel.
The backward uses of the TPU kernel (dx with w transposed, dw with x
transposed) are not ported yet, so no input may require grad.
"""

from __future__ import annotations

import torch

from uno_tpu_torch.ops.kernels._build import check, library

LAUNCHES = 0  # kernel launches since the count was last set to 0


def cmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The contraction as one complex einsum: the kernel's reference."""
    return torch.einsum("bim,iom->bom", x, w)


def _validate(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dtype != torch.complex64 or w.dtype != torch.complex64:
        raise TypeError(f"cmul takes complex64, got {x.dtype} and {w.dtype}")
    if x.ndim != 3 or w.ndim != 3:
        raise ValueError(f"cmul takes x (B,Ci,M), w (Ci,Co,M); got {x.shape}, {w.shape}")
    if x.shape[1] != w.shape[0] or x.shape[2] != w.shape[2]:
        raise ValueError(f"cmul shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("cmul takes contiguous x and w")
    if x.device != w.device:
        raise ValueError(f"cmul: x on {x.device}, w on {w.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("cmul has no backward yet: call it under torch.no_grad()")
    if not 0 < min(*x.shape, *w.shape) <= max(*x.shape, *w.shape) < 2**31:
        raise ValueError(f"cmul: dimensions must be in [1, 2**31): {x.shape}, {w.shape}")


def cmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, Ci, M) complex64, w (Ci, Co, M) complex64 -> (B, Co, M)."""
    global LAUNCHES
    _validate(x, w)
    if x.device.type == "cpu":
        return cmul_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"cmul runs on cpu or cuda, not {x.device}")
    lib = library()
    b, ci, m = x.shape
    co = w.shape[1]
    y = torch.empty((b, co, m), dtype=torch.complex64, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.uno_cmul_fwd(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), b, ci, co, m, stream
        )
    check(err, "uno_cmul_fwd")
    LAUNCHES += 1
    return y
