"""Fused projection head ``fc2(gelu(fc1(x)))`` over channels-first input.

Replaces the TPU kernel ``uno_tpu/ops/pallas/mlp_head.py: _fwd_kernel``
(launched by ``_fwd_call``; public entry ``fused_mlp_head``).  The hidden
activation is never written to device memory: each thread of the CUDA kernel
in ``uno_tpu_torch/csrc/mlp_head.cu`` computes one grid point's hidden layer
in registers, from weights held in shared memory.

On an H100 the head is bound by reading x (bf16, B*C*N*2 bytes); the unfused
composition would also write and re-read an f32 (B, N, H) hidden tensor.
Contract, as in ``uno_tpu``: x is bf16; weights, dots, the exact-erf GELU and
the output are f32.

A tensor on the CPU goes to ``mlp_head_plain``; a CUDA tensor goes to the
kernel.  The backward (``_bwd_kernel``) is not ported yet, so no input may
require grad.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from uno_tpu_torch.ops.kernels._build import check, library

LAUNCHES = 0  # kernel launches since the count was last set to 0
MAX_OUT = 4  # output channels the kernel's register accumulators cover
MAX_SMEM = 48 * 1024  # weights live in shared memory without an opt-in


def mlp_head_plain(x, k1, b1, k2, b2):
    """The unfused composition on the channels-last view (f32 math)."""
    y = x.float().movedim(1, -1)
    y = F.gelu(y @ k1 + b1) @ k2 + b2
    return y.movedim(-1, 1)


def _validate(x, k1, b1, k2, b2) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"mlp_head takes bf16 x, got {x.dtype}")
    for name, t in (("k1", k1), ("b1", b1), ("k2", k2), ("b2", b2)):
        if t.dtype != torch.float32:
            raise TypeError(f"mlp_head takes f32 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"mlp_head takes a contiguous {name}")
        if t.device != x.device:
            raise ValueError(f"mlp_head: x on {x.device}, {name} on {t.device}")
    if x.ndim < 3 or not x.is_contiguous():
        raise ValueError(f"mlp_head takes a contiguous (B, C, *spatial) x, got {x.shape}")
    c, h = k1.shape
    o = k2.shape[1]
    if x.shape[1] != c or b1.shape != (h,) or k2.shape != (h, o) or b2.shape != (o,):
        raise ValueError(
            f"mlp_head shapes: x {tuple(x.shape)}, k1 {tuple(k1.shape)}, "
            f"b1 {tuple(b1.shape)}, k2 {tuple(k2.shape)}, b2 {tuple(b2.shape)}"
        )
    if not 1 <= o <= MAX_OUT:
        raise ValueError(f"mlp_head covers 1..{MAX_OUT} outputs, got {o}")
    smem = 4 * (c * h + h + h * o + o)
    if smem > MAX_SMEM:
        raise ValueError(f"mlp_head weights need {smem} B of shared memory > {MAX_SMEM}")
    if not 0 < x.numel() < 2**31 or x.shape[0] > 65535:
        raise ValueError(f"mlp_head: x must be non-empty, < 2**31 elements and "
                         f"batch <= 65535 (the grid's y limit), got {x.shape}")
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, k1, b1, k2, b2)
    ):
        raise RuntimeError("mlp_head has no backward yet: call it under torch.no_grad()")


def mlp_head(x, k1, b1, k2, b2):
    """x (B, C, *spatial) bf16; k1 (C, H), b1 (H), k2 (H, O), b2 (O) f32
    (Dense kernels in uno_tpu's [in, out] layout) -> (B, O, *spatial) f32."""
    global LAUNCHES
    _validate(x, k1, b1, k2, b2)
    bsz, c = x.shape[:2]
    spatial = tuple(x.shape[2:])
    xf = x.reshape(bsz, c, -1)
    if x.device.type == "cpu":
        out = mlp_head_plain(xf, k1, b1, k2, b2)
        return out.reshape((bsz, -1) + spatial)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_head runs on cpu or cuda, not {x.device}")
    lib = library()
    n = xf.shape[2]
    h, o = k2.shape
    out = torch.empty((bsz, o, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.uno_mlp_head_fwd(
            xf.data_ptr(), k1.data_ptr(), b1.data_ptr(), k2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), bsz, c, n, h, o, stream,
        )
    check(err, "uno_mlp_head_fwd")
    LAUNCHES += 1
    return out.reshape((bsz, o) + spatial)
