"""Fused projection head ``fc2(gelu(fc1(x)))`` over channels-first input,
and its backward.

Replaces the TPU kernels ``uno_tpu/ops/pallas/mlp_head.py: _fwd_kernel``
(launched by ``_fwd_call``; public entry ``fused_mlp_head``) and
``_bwd_kernel`` (launched by ``_bwd_call``; the VJP ``_fused_bwd``).  The
hidden activation is never written to device memory: both CUDA kernels of
``uno_tpu_torch/csrc/mlp_head.cu`` compute it from x, with the same tile
code, as register-blocked products over tiles of grid points, laid out by
``fwd_plan`` and ``bwd_plan`` below.

On an H100 both kernels are bound by their f32 multiply-adds (C*H per grid
point forward, 3*C*H backward), not by reading x and writing gx (bf16,
B*C*N*2 bytes each); the unfused composition would also write and re-read
an f32 (B, N, H) hidden tensor.  Contract, as in
``uno_tpu``'s default f32-dot branch: x is bf16; weights, dots, the
exact-erf GELU, the output and every weight gradient are f32; only gx is
rounded, to x's dtype.

``mlp_head`` is differentiable: when grad mode is on and an input requires
grad it runs as a ``torch.autograd.Function`` that saves ``(x, k1, b1, k2)``
(as ``_fused_fwd`` does) and whose backward is ``mlp_head_bwd``.  Otherwise
it calls the forward alone and saves nothing.

The forward is also the custom op ``uno_tpu_torch::mlp_head_fwd``
(``torch.library``), so that ``torch.export`` records it as one node of the
graph; as for ``cmul.contract``, only tracing goes through it, and eager
calls launch directly.

A tensor on the CPU goes to the plain versions; a CUDA tensor goes to the
kernels.

``set_fused_head_mode`` and ``UNO_TPU_TORCH_NO_FUSED_HEAD=1`` (port of
``uno_tpu``'s ``set_fused_head_mode`` / ``UNO_TPU_NO_FUSED_HEAD``) turn the
kernel off: ``UNOModel`` then takes the unfused f32 Dense pair.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from uno_tpu_torch.ops.kernels._build import MAX_SMEM as CARD_SMEM
from uno_tpu_torch.ops.kernels._build import SMS, check, device_limits, library

# kernel launches per entry point since the counts were last set to 0
LAUNCHES = {"fwd": 0, "bwd": 0}
MAX_OUT = 4  # output channels the kernels' register accumulators cover
# the kernels' constants (csrc/mlp_head.cu: BT, MAX_MT, MAX_NHQ of the backward;
# CT, PW, FNP of the forward: compute threads, producer warps, 4-point groups per item)
BWD_THREADS, BWD_MAX_MT, BWD_MAX_NHQ = 256, 4, 32
FWD_COMPUTE, FWD_PRODUCERS, FWD_POINT_GROUPS = 128, 4, 2
TILES = (128, 64, 32)  # grid points per tile, largest first
BWD_SMALL_SUMS = 4 + 5 * MAX_OUT  # a thread's running gb1, gk2 and gb2 sums (csrc: NS)


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
    if not 0 < x.numel() < 2**31:
        raise ValueError(f"mlp_head: x must be non-empty and < 2**31 elements, got {x.shape}")


def _mlp_head_fwd(x, k1, b1, k2, b2):
    """x (B, C, N) -> (B, O, N) f32.  The plan is made on the CPU too (for an
    H100), so that a head the kernel does not take raises there as well."""
    bsz, c, n = x.shape
    h, o = k2.shape
    plan = fwd_plan(bsz, c, n, h, o, x.device.index if x.device.type == "cuda" else None)
    if x.device.type == "cpu":
        return mlp_head_plain(x, k1, b1, k2, b2)
    if x.data_ptr() % 16:  # the kernel copies 16-byte vectors of x
        x = x.clone()
    out = torch.empty((bsz, o, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().uno_mlp_head_fwd(
            x.data_ptr(), k1.data_ptr(), b1.data_ptr(), k2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), bsz, c, n, h, o, *plan.args(), stream,
        )
    check(err, "uno_mlp_head_fwd")
    LAUNCHES["fwd"] += 1
    return out


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _per_sm(smem: int, max_smem: int) -> int:
    """Blocks per SM that the grid is sized for: two where two fit."""
    return 2 if 2 * smem <= max_smem else 1


def bwd_hidden(h: int) -> int:
    """H padded to 4 times a power of two (csrc/mlp_head.cu: hidden_padded):
    every thread of either kernel owns whole 4-unit hidden groups."""
    q = 1
    while 4 * q < h:
        q *= 2
    return 4 * q


def bwd_shares(c: int, hp: int) -> int:
    """gk1 shares of 4 channels x 4 hidden units per thread of each half of
    the block, rounded up to 1, 2 or 4 (csrc/mlp_head.cu: bwd_mt)."""
    need = -(-(_up(c, 4) // 4) * (hp // 4) // (BWD_THREADS // 2))
    return next((m for m in (1, 2, BWD_MAX_MT) if need <= m), need)


def fwd_smem(c: int, hp: int, tile: int) -> int:
    """Shared-memory bytes of a forward block (csrc/mlp_head.cu: FwdSmem):
    k1 as [C][Hp], b1, k2 as [MAX_OUT][Hp], b2, the rows' offsets, a ring
    of two bf16 x tiles and two f32 x tiles."""
    return (4 * (c * hp + hp + MAX_OUT * hp + MAX_OUT) + _up(8 * c, 16)
            + 2 * 2 * c * (tile + 8) + 2 * 4 * c * (tile + 4))


@dataclass(frozen=True)
class FwdPlan:
    """How the forward covers the B*N grid points: tiles of ``tile`` points
    of one batch row, walked as the backward's (``BwdPlan``).  A block has
    ``FWD_COMPUTE`` compute threads and ``FWD_PRODUCERS`` warps that stage
    and unpack x.  In a tile a compute thread's items are 4 *
    ``FWD_POINT_GROUPS`` points x 4 hidden units; min(hidden / 4, 32)
    neighbouring threads share a point group and add their partial outputs
    by shuffles."""

    tile: int      # grid points per tile
    threads: int
    hidden: int    # H padded (bwd_hidden)
    smem: int      # dynamic shared memory per block, bytes
    blocks: int    # the grid

    def args(self) -> tuple:
        """The plan arguments of ``uno_mlp_head_fwd``."""
        return self.tile, self.threads, self.hidden, self.smem, self.blocks


def fwd_plan(bsz: int, c: int, n: int, h: int, o: int, device: int | None = None) -> FwdPlan:
    """The launch plan of the forward for x (bsz, c, n) and k2 (h, o): the
    largest tile whose shared memory (the padded k1 and the x tiles) fits
    the card, and two blocks per SM where two fit.  ``device``: the CUDA
    device whose SMs and shared memory the plan fills (None: an H100's).
    Raises ValueError for a shape the kernel does not cover."""
    if min(bsz, c, n, h, o) < 1:
        raise ValueError(f"mlp_head: empty shape {(bsz, c, n, h, o)}")
    if o > MAX_OUT:
        raise ValueError(f"mlp_head covers 1..{MAX_OUT} outputs, got {o}")
    hp = bwd_hidden(h)
    sms, max_smem = (SMS, CARD_SMEM) if device is None else device_limits(device)
    tile = next((t for t in TILES if fwd_smem(c, hp, t) <= max_smem), None)
    if tile is None:
        raise ValueError(f"mlp_head needs {fwd_smem(c, hp, TILES[-1])} B of shared memory "
                         f"for C={c}, H={h} (padded {hp}) > the card's {max_smem}")
    smem = fwd_smem(c, hp, tile)
    blocks = min(bsz * -(-n // tile), _per_sm(smem, max_smem) * sms)
    return FwdPlan(tile, FWD_COMPUTE + 32 * FWD_PRODUCERS, hp, smem, blocks)


def bwd_smem(c: int, hp: int, tile: int, shares: int) -> int:
    """Shared-memory bytes of a backward block (csrc/mlp_head.cu: BwdSmem):
    k1 as [C][Hp] and [Hp][C8], b1, k2, the rows' offsets, a ring of two
    bf16 x tiles and two g tiles, the f32 x tile and dz; at the end the
    threads' small sums and half the gk1 shares reuse the tiles."""
    weights = 4 * (c * hp + hp * _up(c, 8) + hp + hp * MAX_OUT) + _up(8 * c, 16)
    tiles = (2 * 2 * c * (tile + 8) + 2 * 4 * MAX_OUT * tile
             + 4 * (_up(c, 4) + hp) * (tile + 4))
    red = 4 * (BWD_THREADS * BWD_SMALL_SUMS + shares * 16 * BWD_THREADS // 2)
    return weights + max(tiles, red)


@dataclass(frozen=True)
class BwdPlan:
    """How the backward's pass 1 covers the B*N grid points: tiles of
    ``tile`` points of one batch row, tile t at (t // tiles_per_row,
    t % tiles_per_row * tile), walked by block ``i`` as t = i, i + blocks, ..."""

    tile: int      # grid points per tile
    threads: int
    hidden: int    # H padded (bwd_hidden)
    shares: int    # gk1 shares of 4 x 4 entries per thread (bwd_shares)
    smem: int      # dynamic shared memory per block, bytes
    blocks: int    # pass 1's grid, and the rows of its partial sums

    def args(self) -> tuple:
        """The plan arguments of ``uno_mlp_head_bwd``."""
        return self.tile, self.threads, self.hidden, self.shares, self.smem, self.blocks


def bwd_plan(bsz: int, c: int, n: int, h: int, o: int, device: int | None = None) -> BwdPlan:
    """The launch plan of the backward for x (bsz, c, n) and k2 (h, o):
    the largest tile whose shared memory fits the card, and two blocks per
    SM where two fit.  ``device``: the CUDA device whose SMs and shared
    memory the plan fills (None: an H100's).  Raises ValueError for a shape
    the kernel does not cover."""
    if min(bsz, c, n, h, o) < 1:
        raise ValueError(f"mlp_head_bwd: empty shape {(bsz, c, n, h, o)}")
    hp = bwd_hidden(h)
    if hp // 4 > BWD_MAX_NHQ or o > MAX_OUT:
        raise ValueError(f"mlp_head_bwd covers up to {4 * BWD_MAX_NHQ} hidden units and "
                         f"{MAX_OUT} outputs, got {h} and {o}")
    shares = bwd_shares(c, hp)
    if shares > BWD_MAX_MT:
        raise ValueError(f"mlp_head_bwd: gk1 ({c} x {h}, padded {_up(c, 4)} x {hp}) needs "
                         f"{shares} register shares per thread > {BWD_MAX_MT}")
    sms, max_smem = (SMS, CARD_SMEM) if device is None else device_limits(device)
    tile = next((t for t in TILES if bwd_smem(c, hp, t, shares) <= max_smem), None)
    if tile is None:
        raise ValueError(f"mlp_head_bwd needs {bwd_smem(c, hp, TILES[-1], shares)} B of "
                         f"shared memory > the card's {max_smem}")
    smem = bwd_smem(c, hp, tile, shares)
    per_sm = _per_sm(smem, max_smem) if shares < BWD_MAX_MT else 1
    blocks = min(bsz * -(-n // tile), per_sm * sms)
    return BwdPlan(tile, BWD_THREADS, hp, shares, smem, blocks)


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
    return _bwd_launch(x, g, k1, b1, k2)


def _bwd_launch(x, g, k1, b1, k2):
    bsz, c, n = x.shape
    h, o = k2.shape
    plan = bwd_plan(bsz, c, n, h, o, x.device.index)
    if x.data_ptr() % 16:  # the kernel copies 16-byte vectors of x and gx
        x = x.clone()
    n_grad = c * h + h + h * o + o
    dev = x.device
    gx = torch.empty_like(x)
    gk1 = torch.empty((c, h), dtype=torch.float32, device=dev)
    gb1 = torch.empty((h,), dtype=torch.float32, device=dev)
    gk2 = torch.empty((h, o), dtype=torch.float32, device=dev)
    gb2 = torch.empty((o,), dtype=torch.float32, device=dev)
    partial = torch.empty((plan.blocks, n_grad), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().uno_mlp_head_bwd(
            x.data_ptr(), g.data_ptr(), k1.data_ptr(), b1.data_ptr(),
            k2.data_ptr(), gx.data_ptr(), gk1.data_ptr(), gb1.data_ptr(),
            gk2.data_ptr(), gb2.data_ptr(), partial.data_ptr(),
            bsz, c, n, h, o, *plan.args(), stream,
        )
    check(err, "uno_mlp_head_bwd")
    LAUNCHES["bwd"] += 1
    return gx, gk1, gb1, gk2, gb2


@torch.library.custom_op("uno_tpu_torch::mlp_head_fwd", mutates_args=())
def mlp_head_fwd(x: torch.Tensor, k1: torch.Tensor, b1: torch.Tensor, k2: torch.Tensor,
                 b2: torch.Tensor) -> torch.Tensor:
    """The head's forward on a flat (B, C, N) x as a custom op: the kernel
    for a CUDA tensor, the plain version for a CPU one."""
    _validate_flat(x, k1, b1, k2, b2)
    return _mlp_head_fwd(x, k1, b1, k2, b2).contiguous()


def _validate_flat(x, k1, b1, k2, b2) -> None:
    _validate(x, k1, b1, k2, b2)
    if x.ndim != 3:
        raise ValueError(f"mlp_head_fwd takes a flat (B, C, N) x, got {tuple(x.shape)}")


@mlp_head_fwd.register_fake
def _mlp_head_fwd_fake(x, k1, b1, k2, b2):
    _validate_flat(x, k1, b1, k2, b2)
    bsz, _, n = x.shape
    h, o = k2.shape
    fwd_plan(bsz, x.shape[1], n, h, o)  # raises for a head the kernel does not take
    return x.new_empty((bsz, o, n), dtype=torch.float32)


def _forward(x, k1, b1, k2, b2):
    if torch.compiler.is_exporting():
        return mlp_head_fwd(x, k1, b1, k2, b2)
    return _mlp_head_fwd(x, k1, b1, k2, b2)


class _MLPHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k1, b1, k2, b2):
        ctx.save_for_backward(x, k1, b1, k2)
        return _forward(x, k1, b1, k2, b2)

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
        out = _forward(xf, k1, b1, k2, b2)
    return out.reshape((bsz, -1) + spatial)


# The head switch: None = the environment decides (UNO_TPU_TORCH_NO_FUSED_HEAD=1
# turns the kernel off, anything else leaves it on where it applies: a 2-D
# bf16 model without ``proj_concat_lift``), True/False = forced.  Read by
# ``UNOModel`` before it calls the head, never after an error.
_FUSED_HEAD_MODE = None


def set_fused_head_mode(enabled) -> None:
    """Force (True/False) or leave to the environment (None) the fused
    projection head."""
    global _FUSED_HEAD_MODE
    _FUSED_HEAD_MODE = enabled


def fused_head_enabled() -> bool:
    if _FUSED_HEAD_MODE is not None:
        return _FUSED_HEAD_MODE
    return os.environ.get("UNO_TPU_TORCH_NO_FUSED_HEAD") != "1"
