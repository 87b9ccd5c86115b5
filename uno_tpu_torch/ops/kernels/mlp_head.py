"""Fused projection head ``fc2(gelu(fc1(x)))`` over channels-first input,
and its backward.

Replaces the TPU kernels ``uno_tpu/ops/pallas/mlp_head.py: _fwd_kernel``
(launched by ``_fwd_call``; public entry ``fused_mlp_head``) and
``_bwd_kernel`` (launched by ``_bwd_call``; the VJP ``_fused_bwd``).  The
hidden activation is never written to device memory: each thread of the
CUDA kernels in ``uno_tpu_torch/csrc/mlp_head.cu`` computes one grid point's
hidden layer in registers, from weights held in shared memory, and the
backward recomputes it from x.

On an H100 the head is bound by reading x (bf16, B*C*N*2 bytes) and, in the
backward, writing gx of the same size; the unfused composition would also
write and re-read an f32 (B, N, H) hidden tensor.  Contract, as in
``uno_tpu``'s default f32-dot branch: x is bf16; weights, dots, the
exact-erf GELU, the output and every weight gradient are f32; only gx is
rounded, to x's dtype.

``mlp_head`` is differentiable: when grad mode is on and an input requires
grad it runs as a ``torch.autograd.Function`` that saves ``(x, k1, b1, k2)``
(as ``_fused_fwd`` does) and whose backward is ``mlp_head_bwd``.  Otherwise
it calls the forward alone and saves nothing.

A tensor on the CPU goes to the plain versions; a CUDA tensor goes to the
kernels.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from uno_tpu_torch.ops.kernels._build import check, library

# kernel launches per entry point since the counts were last set to 0
LAUNCHES = {"fwd": 0, "bwd": 0}
MAX_OUT = 4  # output channels the kernels' register accumulators cover
MAX_SMEM = 48 * 1024  # forward: weights live in shared memory without an opt-in
BWD_MAX_SMEM = 232448  # backward opts in up to the H100's 227 KB per block
BWD_THREADS = 128  # backward: grid points per tile, one per thread
BWD_BLOCKS = 264  # backward pass 1: a fixed grid (two blocks per H100 SM)


def mlp_head_plain(x, k1, b1, k2, b2):
    """The unfused composition on the channels-last view (f32 math)."""
    y = x.float().movedim(1, -1)
    y = F.gelu(y @ k1 + b1) @ k2 + b2
    return y.movedim(-1, 1)


def mlp_head_bwd_plain(x, g, k1, b1, k2):
    """The backward written out in f32 on the channels-last view: the
    backward kernel's reference.  x (B, C, N), g (B, O, N) ->
    (gx in x's dtype, gk1, gb1, gk2, gb2)."""
    c = x.shape[1]
    xf = x.float().movedim(1, -1).reshape(-1, c)           # (P, C)
    gf = g.float().movedim(1, -1).reshape(-1, k2.shape[1])  # (P, O)
    z = xf @ k1 + b1
    cdf = 0.5 * (1.0 + torch.erf(z * math.sqrt(0.5)))
    dgelu = cdf + z * torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    dz = (gf @ k2.t()) * dgelu
    gx = (dz @ k1.t()).reshape(x.shape[0], -1, c).movedim(-1, 1)
    return gx.to(x.dtype), xf.t() @ dz, dz.sum(0), F.gelu(z).t() @ gf, gf.sum(0)


def _validate(x, k1, b1, k2, b2=None) -> None:
    """The checks of both entry points (the backward has no b2)."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"mlp_head takes bf16 x, got {x.dtype}")
    weights = (("k1", k1), ("b1", b1), ("k2", k2)) + ((("b2", b2),) if b2 is not None else ())
    for name, t in weights:
        if t.dtype != torch.float32:
            raise TypeError(f"mlp_head takes f32 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"mlp_head takes a contiguous {name}")
        if t.device != x.device:
            raise ValueError(f"mlp_head: x on {x.device}, {name} on {t.device}")
    if x.ndim < 3 or not x.is_contiguous():
        raise ValueError(f"mlp_head takes a contiguous (B, C, *spatial) x, got {x.shape}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mlp_head runs on cpu or cuda, not {x.device}")
    c, h = k1.shape
    o = k2.shape[1]
    if (x.shape[1] != c or b1.shape != (h,) or k2.shape[:1] != (h,)
            or (b2 is not None and b2.shape != (o,))):
        raise ValueError(
            f"mlp_head shapes: x {tuple(x.shape)}, k1 {tuple(k1.shape)}, "
            f"b1 {tuple(b1.shape)}, k2 {tuple(k2.shape)}, "
            f"b2 {None if b2 is None else tuple(b2.shape)}"
        )
    if not 1 <= o <= MAX_OUT:
        raise ValueError(f"mlp_head covers 1..{MAX_OUT} outputs, got {o}")
    smem = 4 * (c * h + h + h * o + o)
    if smem > MAX_SMEM:
        raise ValueError(f"mlp_head weights need {smem} B of shared memory > {MAX_SMEM}")
    if not 0 < x.numel() < 2**31 or x.shape[0] > 65535:
        raise ValueError(f"mlp_head: x must be non-empty, < 2**31 elements and "
                         f"batch <= 65535 (the grid's y limit), got {x.shape}")


def _mlp_head_fwd(x, k1, b1, k2, b2):
    """x (B, C, N) -> (B, O, N) f32."""
    if x.device.type == "cpu":
        return mlp_head_plain(x, k1, b1, k2, b2)
    bsz, c, n = x.shape
    h, o = k2.shape
    out = torch.empty((bsz, o, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().uno_mlp_head_fwd(
            x.data_ptr(), k1.data_ptr(), b1.data_ptr(), k2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), bsz, c, n, h, o, stream,
        )
    check(err, "uno_mlp_head_fwd")
    LAUNCHES["fwd"] += 1
    return out


def mlp_head_bwd(x, g, k1, b1, k2):
    """Gradients of ``mlp_head`` for the output cotangent g.

    x (B, C, N) bf16, g (B, O, N) f32, k1 (C, H), b1 (H), k2 (H, O) f32 ->
    (gx (B, C, N) in x's dtype, gk1 (C, H), gb1 (H), gk2 (H, O), gb2 (O)).
    """
    _validate(x, k1, b1, k2)
    if x.ndim != 3:
        raise ValueError(f"mlp_head_bwd takes a flat (B, C, N) x, got {tuple(x.shape)}")
    bsz, c, n = x.shape
    h, o = k2.shape
    if g.dtype != torch.float32 or g.shape != (bsz, o, n) or not g.is_contiguous():
        raise ValueError(f"mlp_head_bwd takes a contiguous f32 g of shape "
                         f"{(bsz, o, n)}, got {g.dtype} {tuple(g.shape)}")
    if g.device != x.device:
        raise ValueError(f"mlp_head_bwd: x on {x.device}, g on {g.device}")
    if x.device.type == "cpu":
        return mlp_head_bwd_plain(x, g, k1, b1, k2)
    t = BWD_THREADS
    smem = 4 * (2 * (c * h + h + h * o) + o + t * (c + 2 * h + o + 3))
    if smem > BWD_MAX_SMEM:
        raise ValueError(f"mlp_head_bwd needs {smem} B of shared memory > {BWD_MAX_SMEM}")
    blocks = min(BWD_BLOCKS, -(-bsz * n // t))
    n_grad = c * h + h + h * o + o
    dev = x.device
    gx = torch.empty_like(x)
    gk1 = torch.empty((c, h), dtype=torch.float32, device=dev)
    gb1 = torch.empty((h,), dtype=torch.float32, device=dev)
    gk2 = torch.empty((h, o), dtype=torch.float32, device=dev)
    gb2 = torch.empty((o,), dtype=torch.float32, device=dev)
    partial = torch.empty((blocks, n_grad), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().uno_mlp_head_bwd(
            x.data_ptr(), g.data_ptr(), k1.data_ptr(), b1.data_ptr(),
            k2.data_ptr(), gx.data_ptr(), gk1.data_ptr(), gb1.data_ptr(),
            gk2.data_ptr(), gb2.data_ptr(), partial.data_ptr(),
            bsz, c, n, h, o, t, blocks, stream,
        )
    check(err, "uno_mlp_head_bwd")
    LAUNCHES["bwd"] += 1
    return gx, gk1, gb1, gk2, gb2


class _MLPHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k1, b1, k2, b2):
        ctx.save_for_backward(x, k1, b1, k2)
        return _mlp_head_fwd(x, k1, b1, k2, b2)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, k1, b1, k2 = ctx.saved_tensors
        return mlp_head_bwd(x, g.float().contiguous(), k1, b1, k2)


def mlp_head(x, k1, b1, k2, b2):
    """x (B, C, *spatial) bf16; k1 (C, H), b1 (H), k2 (H, O), b2 (O) f32
    (Dense kernels in uno_tpu's [in, out] layout) -> (B, O, *spatial) f32."""
    _validate(x, k1, b1, k2, b2)
    bsz, c = x.shape[:2]
    spatial = tuple(x.shape[2:])
    xf = x.reshape(bsz, c, -1)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, k1, b1, k2, b2)):
        out = _MLPHead.apply(xf, k1, b1, k2, b2)
    else:
        out = _mlp_head_fwd(xf, k1, b1, k2, b2)
    return out.reshape((bsz, -1) + spatial)
