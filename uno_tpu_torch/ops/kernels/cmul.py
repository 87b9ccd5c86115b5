"""Complex mode contraction ``y[b,o,m] = sum_i x[b,i,m] * w[i,o,m]`` and its
gradients.

Replaces the TPU kernel ``uno_tpu/ops/pallas/cmul.py: _contract_kernel``
(launched by ``lane_contract``) in its three uses: the forward, where the
FFT-path spectral conv contracts the kept Fourier corners of the input
against the spectral weights (one small complex (B x Ci) @ (Ci x Co) product
per mode), and the two backward contractions, dx and dw
(``uno_tpu/ops/pallas/cmul.py: _bwd``).

The CUDA kernels in ``uno_tpu_torch/csrc/cmul.cu`` read or write each
weight-sized element (Ci*Co*M complex values, each used by B multiply-adds)
once, with coalesced accesses along the mode axis.  On an H100 they are
bound by the latency of a serial channel loop over too few threads, not by
those bytes; the source says more.

``cmul`` is differentiable: when grad mode is on and an input requires grad
it runs as a ``torch.autograd.Function`` whose backward calls ``cmul_bwd_x``
and ``cmul_bwd_w``, each only for an input that needs it.  The gradients are
torch's (conjugate-Wirtinger) convention, the conjugates of ``jax.grad``'s:
``gx = g @ conj(w)``, ``gw = conj(x) @ g``.  Otherwise (``no_grad``,
``inference_mode``) it calls the forward alone and saves nothing.

A tensor on the CPU goes to the plain versions (complex64, or complex128 for
``gradcheck``); a CUDA tensor goes to the kernels.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from uno_tpu_torch.ops.kernels._build import check, library

# kernel launches per entry point since the counts were last set to 0
LAUNCHES = {"fwd": 0, "bwd_x": 0, "bwd_w": 0}


def cmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The contraction as one complex einsum: the forward kernel's reference."""
    return torch.einsum("bim,iom->bom", x, w)


def cmul_bwd_x_plain(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``gx[b,i,m] = sum_o g[b,o,m] * conj(w[i,o,m])``: the dx kernel's reference."""
    return torch.einsum("bom,iom->bim", g, w.conj())


def cmul_bwd_w_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``gw[i,o,m] = sum_b conj(x[b,i,m]) * g[b,o,m]``: the dw kernel's reference."""
    return torch.einsum("bim,bom->iom", x.conj(), g)


def _validate(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    """Checks shared by the three entry points: two 3-D complex operands
    on one device, contiguous, with dimensions the kernels' grids cover."""
    if a.dtype != b.dtype or a.dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f"{name} takes complex64, got {a.dtype} and {b.dtype}")
    if a.ndim != 3 or b.ndim != 3:
        raise ValueError(f"{name} takes 3-D operands, got {tuple(a.shape)}, {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name} takes contiguous operands")
    if a.device != b.device:
        raise ValueError(f"{name}: operands on {a.device} and {b.device}")
    if a.device.type == "cuda" and a.dtype != torch.complex64:
        raise TypeError(f"{name}: the CUDA kernel takes complex64, got {a.dtype}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {a.device}")
    dims = (*a.shape, *b.shape)
    if not 0 < min(dims) <= max(dims) < 2**31:
        raise ValueError(f"{name}: dimensions must be in [1, 2**31): {a.shape}, {b.shape}")


def _launch(entry: str, key: str, a, b, out_shape, bsz, ci, co, m):
    if max(ci, co) > 4 * 65535 or bsz > 8 * 65535:
        raise ValueError(f"{entry}: channels {ci}, {co} or batch {bsz} exceed the grid")
    out = torch.empty(out_shape, dtype=torch.complex64, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(library(), entry)(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, ci, co, m, stream
        )
    check(err, entry)
    LAUNCHES[key] += 1
    return out


def _cmul_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _validate("cmul", x, w)
    if x.shape[1] != w.shape[0] or x.shape[2] != w.shape[2]:
        raise ValueError(f"cmul shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if x.device.type == "cpu":
        return cmul_plain(x, w)
    (b, ci, m), co = x.shape, w.shape[1]
    return _launch("uno_cmul_fwd", "fwd", x, w, (b, co, m), b, ci, co, m)


def cmul_bwd_x(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """g (B, Co, M), w (Ci, Co, M) -> gx (B, Ci, M)."""
    _validate("cmul_bwd_x", g, w)
    if g.shape[1] != w.shape[1] or g.shape[2] != w.shape[2]:
        raise ValueError(f"cmul_bwd_x shape mismatch: g {tuple(g.shape)}, w {tuple(w.shape)}")
    if g.device.type == "cpu":
        return cmul_bwd_x_plain(g, w)
    (b, co, m), ci = g.shape, w.shape[0]
    return _launch("uno_cmul_bwd_x", "bwd_x", g, w, (b, ci, m), b, ci, co, m)


def cmul_bwd_w(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x (B, Ci, M), g (B, Co, M) -> gw (Ci, Co, M)."""
    _validate("cmul_bwd_w", x, g)
    if x.shape[0] != g.shape[0] or x.shape[2] != g.shape[2]:
        raise ValueError(f"cmul_bwd_w shape mismatch: x {tuple(x.shape)}, g {tuple(g.shape)}")
    if x.device.type == "cpu":
        return cmul_bwd_w_plain(x, g)
    (b, ci, m), co = x.shape, g.shape[1]
    return _launch("uno_cmul_bwd_w", "bwd_w", x, g, (ci, co, m), b, ci, co, m)


class _CMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _cmul_fwd(x, w)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        gx = cmul_bwd_x(g, w) if ctx.needs_input_grad[0] else None
        gw = cmul_bwd_w(x, g) if ctx.needs_input_grad[1] else None
        return gx, gw


def cmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, Ci, M) complex64, w (Ci, Co, M) complex64 -> (B, Co, M)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _CMul.apply(x, w)
    return _cmul_fwd(x, w)
