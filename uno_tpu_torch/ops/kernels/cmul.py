"""Complex mode contraction ``y[b,o,m] = sum_i x[b,i,m] * w[i,o,m]`` and its
gradients.

Replaces the TPU kernel ``uno_tpu/ops/pallas/cmul.py: _contract_kernel``
(launched by ``lane_contract``) in its three uses: the forward, where the
FFT-path spectral conv contracts the kept Fourier corners of the input
against the spectral weights (one small complex (B x Ci) @ (Ci x Co) product
per mode), and the two backward contractions, dx and dw
(``uno_tpu/ops/pallas/cmul.py: _bwd``).

The three uses run one CUDA kernel, ``contract_kernel`` in
``uno_tpu_torch/csrc/cmul.cu``, which stages both operands in shared memory,
computes register tiles of 4 rows x 4 outputs x 2 modes, splits the channel
reduction over the warps of a block and adds their partial sums in a fixed
order; ``contract_plan`` below picks its split, shared memory and grid, and
the source says more.

``cmul`` is differentiable: when grad mode is on and an input requires grad
it runs as a ``torch.autograd.Function`` whose backward calls ``cmul_bwd_x``
and ``cmul_bwd_w``, each only for an input that needs it.  The gradients are
torch's (conjugate-Wirtinger) convention, the conjugates of ``jax.grad``'s:
``gx = g @ conj(w)``, ``gw = conj(x) @ g``.  Otherwise (``no_grad``,
``inference_mode``) it calls the forward alone and saves nothing.

The forward is also the custom op ``uno_tpu_torch::contract``
(``torch.library``), so that ``torch.export`` records it as one node of the
graph and an exported program runs it: the CUDA kernel on the card, the
plain version on the CPU.  Only tracing goes through the op
(``torch.compiler.is_exporting()``); eager calls launch directly, because
the op's Python dispatch adds host time to every call (PERF.md §6).

A tensor on the CPU goes to the plain versions (complex64, or complex128 for
``gradcheck``); a CUDA tensor goes to the kernels.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.autograd.function import once_differentiable

from uno_tpu_torch.ops.kernels._build import MAX_SMEM, SMS, check, device_limits, library

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


# the kernel's constants (csrc/cmul.cu: CB, TN, TM2, STAGES, MAX_SPLIT)
TILE_B, TILE_N, TILE_M, STAGES, MAX_SPLIT = 16, 16, 4, 4, 8
GRID_Y_MAX = 65535           # CUDA's limit on the grid's y and z
WARPS_PER_SM = 8             # the split aims at 8 warps per SM
MIN_K_PER_WARP = 4


@dataclass(frozen=True)
class ContractPlan:
    """How ``contract_kernel`` covers ``out[r,n,m] = sum_k a'[r,k,m] w'[k,n,m]``.

    Block ``(gx, gy, gz)`` owns modes ``[gx*TILE_M, +TILE_M)``, outputs
    ``[gy*TILE_N, +TILE_N)`` and rows ``[gz*TILE_B, +TILE_B)``; its warp
    ``kg`` of ``split`` contracts k in ``[kg*k_per_warp, +k_per_warp)``.
    """

    split: int       # warps per block, one slice of K each
    k_per_warp: int
    vec: int         # bytes per copy: 16 (two modes) or 8
    smem: int        # dynamic shared memory per block, bytes
    grid: tuple      # (ceil(M / TILE_M), ceil(N / TILE_N), ceil(R / TILE_B))

    def args(self) -> tuple:
        """The plan arguments of ``uno_cmul_fwd``, ``uno_cmul_bwd_x`` and
        ``uno_cmul_bwd_w``."""
        return (self.split, self.k_per_warp, self.vec, self.smem, *self.grid)


def contract_smem(split: int) -> int:
    """Shared-memory bytes of a block (csrc/cmul.cu: contract_smem): per warp
    an a ring and a w ring, or its partial sums, whichever is larger."""
    rings = STAGES * (TILE_B + TILE_N) * TILE_M * 8
    red = TILE_B * TILE_N * TILE_M * 8
    return split * max(rings, red)


def contract_plan(rows: int, k: int, n: int, m: int, aligned: bool = True,
                  device: int | None = None) -> ContractPlan:
    """The launch plan of ``contract_kernel`` for a (rows, k, m) ``a`` and n
    outputs per mode: (B, Ci, Co) for the forward, (B, Co, Ci) for dx,
    (Ci, B, Co) for dw.  ``aligned``: every pointer is 16-byte aligned;
    ``device``: the CUDA device whose SMs and shared memory the plan fills
    (None: an H100's).  Raises ValueError where the grid cannot take the
    shape."""
    if min(rows, k, n, m) < 1:
        raise ValueError(f"contraction: empty shape {(rows, k, n, m)}")
    grid = (-(-m // TILE_M), -(-n // TILE_N), -(-rows // TILE_B))
    if max(grid[1:]) > GRID_Y_MAX:
        raise ValueError(f"contraction: {n} outputs and {rows} rows need a grid of {grid}, "
                         f"past {GRID_Y_MAX} blocks along y or z")
    sms, max_smem = (SMS, MAX_SMEM) if device is None else device_limits(device)
    if contract_smem(1) > max_smem:
        raise ValueError(f"contraction: a block needs {contract_smem(1)} B of shared memory "
                         f"> the card's {max_smem}")
    split = 1
    while (split < MAX_SPLIT and grid[0] * grid[1] * grid[2] * split < sms * WARPS_PER_SM
           and k >= 2 * split * MIN_K_PER_WARP and contract_smem(2 * split) <= max_smem):
        split *= 2
    k_per_warp = -(-k // split)
    split = -(-k // k_per_warp)  # no warp without channels
    vec = 16 if aligned and m % 2 == 0 else 8
    return ContractPlan(split, k_per_warp, vec, contract_smem(split), grid)


def _launch(entry: str, key: str, a, b, out_shape, bsz, ci, co, m):
    # (rows, k, n) of the kernel's product for each use
    rows, k, n = {"fwd": (bsz, ci, co), "bwd_x": (bsz, co, ci), "bwd_w": (ci, bsz, co)}[key]
    # out comes from the caching allocator, aligned to 512 bytes
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    plan = contract_plan(rows, k, n, m, aligned, a.device.index).args()
    out = torch.empty(out_shape, dtype=torch.complex64, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(library(), entry)(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, ci, co, m, *plan, stream
        )
    check(err, entry)
    LAUNCHES[key] += 1
    return out


def _validate_fwd(x: torch.Tensor, w: torch.Tensor) -> None:
    _validate("cmul", x, w)
    if x.shape[1] != w.shape[0] or x.shape[2] != w.shape[2]:
        raise ValueError(f"cmul shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}")


def _cmul_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _validate_fwd(x, w)
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


@torch.library.custom_op("uno_tpu_torch::contract", mutates_args=())
def contract(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The forward contraction as a custom op: the kernel for a CUDA
    tensor, the plain version for a CPU one."""
    return _cmul_fwd(x, w)


@contract.register_fake
def _contract_fake(x, w):
    _validate_fwd(x, w)
    return x.new_empty((x.shape[0], w.shape[1], x.shape[2]))


def _forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if torch.compiler.is_exporting():
        return contract(x, w)
    return _cmul_fwd(x, w)


class _CMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

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
    return _forward(x, w)
