"""Spectral (Fourier) integral operators: port of the 1-, 2- and 3-D convs
and the 3-D Fourier truncation of ``uno_tpu/ops/spectral.py``, each on both
of its transform paths.

Behavioural contract, as in ``uno_tpu``:

* ``norm="forward"`` on both transform directions, so zero-padding /
  truncation in the Fourier domain acts as value-preserving trigonometric
  interpolation.
* Only the low-|k| corner blocks of the rfft2 spectrum are multiplied by
  learned complex weights; the rest of the output spectrum is zero, sized by
  the requested output grid, so the same layer resamples the domain.

Two paths compute it, chosen by ``set_dft_mode`` or, when that is left at
None, by the environment variable ``UNO_TPU_TORCH_DFT=1``:

* **FFT** (the default on every device until an H100 measurement decides):
  ``rfftn``/``irfftn`` in f32 whatever the input dtype, f32 output.  In
  every rank each spectrum is laid out by one remap
  (``ops/kernels/remap.py``: the CUDA kernel on the card) in each
  direction, around cuFFT and the per-mode complex contraction of
  ``ops/kernels/cmul.py``, and each conv and the 3-D truncation is one
  autograd node with a hand-written backward (``_FFTConv``,
  ``_FFTTruncate3d``), so nothing around them is left to autograd.  A 1-D
  or 2-D spectrum is laid out as a 3-D one with leading axes of length 1.
* **Partial DFT** (``uno_tpu``'s default on the TPU): every stage is one
  einsum against a table of ``ops/dft.py`` on (re, im)-plane data, and the
  contraction is one einsum against a 2x2 block weight tensor.  A bf16
  input runs with bf16 operands and f32 accumulation and gives a bf16
  output; anything else computes in f32.  The backward of each conv and of
  the truncation is written by hand as the mirrored chain of transposed
  stages (``_DFTConv1d``, ``_DFTConv2d``, ``_DFTConv3d``,
  ``_DFTTruncate3d``).

Each 2-D and 3-D op also runs with its first grid axis split over the ranks
of a ``parallel/spatial.py`` ``Split`` (``split=``): no rank holds the whole
grid.  The other axes are transformed locally and the kept modes of the
split axis come from a partial DFT of the rank's own rows at their global
indices, summed over the ranks by one ``psum`` (the kept-mode
block only); every rank contracts the same block (through the CUDA kernel
on the FFT path) and inverts the split axis for its own output rows only,
with no collective.  The backward is autograd's through those stages, the
all-reduce's being an all-reduce.

The 3-D ops are spans (``conv3d``, ``truncate3d``; ``utils/profiling.py``),
``TRANSFORMS_3D`` counts the 3-D transforms of their FFT path's forward by
kind, and ``REMAPS`` the FFT path's remaps of every rank by pass.
"""

from __future__ import annotations

import math
import os
from functools import lru_cache
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from uno_tpu_torch.ops import dft
from uno_tpu_torch.ops.kernels import cmul as cmul_k
from uno_tpu_torch.ops.kernels import remap as remap_k
from uno_tpu_torch.ops.kernels.cmul import cmul
from uno_tpu_torch.parallel.spatial import Split, psum
from uno_tpu_torch.utils.profiling import annotate

# Transform policy: None = the environment decides (UNO_TPU_TORCH_DFT=1 turns
# the partial-DFT path on, anything else leaves the FFT path), True/False =
# forced.  uno_tpu picks the DFT path on the TPU; the port keeps the FFT path
# until the H100 bench picks one.
_DFT_MODE = None

# the 3-D transforms the FFT path has issued since the count was last set to
# 0, by kind: each forward r2c and c2r of ``spectral_conv_3d`` and
# ``fourier_truncate_3d`` (their hand-written backward calls torch.fft
# directly, one adjoint each, uncounted)
TRANSFORMS_3D = {"r2c": 0, "c2r": 0}
# the remaps of the FFT path of every rank since the count was last set to 0,
# on either device, by pass: two a conv and one a truncation each way
REMAPS = {"forward": 0, "backward": 0}


def _counted(t: torch.Tensor, kind: str, rank: int) -> torch.Tensor:
    """``t``, the output of a transform of ``kind`` over ``rank`` axes,
    counted where it is 3-D."""
    if rank == 3:
        TRANSFORMS_3D[kind] += 1
    return t


def set_dft_mode(enabled) -> None:
    """Force (True/False) or leave to the environment (None) the partial-DFT
    matmul path of the spectral transforms."""
    global _DFT_MODE
    _DFT_MODE = enabled


def _dft_enabled() -> bool:
    if _DFT_MODE is not None:
        return _DFT_MODE
    return os.environ.get("UNO_TPU_TORCH_DFT") == "1"


def default_modes_1d(dim1: int) -> int:
    """Reference default: ``modes1 = dim1 // 2`` (integral_operators.py:34)."""
    return dim1 // 2


def default_modes_2d(dim1: int, dim2: int) -> Tuple[int, int]:
    """Reference defaults (integral_operators.py:157-158)."""
    return dim1 // 2 - 1, dim2 // 2


def default_modes_3d(dim1: int, dim2: int, dim3: int) -> Tuple[int, int, int]:
    """Reference defaults (integral_operators.py:331-333)."""
    return dim1, dim2, dim3 // 2 + 1


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


def _join(parts: list) -> torch.Tensor:
    """The pieces' mode blocks joined along the channel axis (one piece: as
    it is)."""
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def spectral_conv_2d(
    x,
    weights: torch.Tensor,
    out_size: Tuple[int, int],
    modes: Tuple[int, int],
    split: Optional[Split] = None,
) -> torch.Tensor:
    """2D spectral conv.  x: (B, Ci, H, W) real -> (B, Co, d1, d2): f32 on
    the FFT path (float64 for a float64 x); on the DFT path bf16 for a bf16
    x, else f32.  With ``split``, x holds its rows of an H = ``split.n``
    grid and the result its rows of d1 (the module docstring).

    x may be a list of channel pieces (B, Ci_k, H, W), Ci the sum of their
    Ci_k (a skip concat carried unconcatenated): each piece is transformed
    alone, and only the kept mode corners of all the pieces are joined
    into one operand for the contraction, so the concatenated input is
    never written.

    weights: (2, Ci, Co, m1, m2) complex64 — block 0 multiplies the
    ``[:m1, :m2]`` (non-negative kx) corner, block 1 the ``[-m1:, :m2]``
    (negative kx) corner of the rfft2 spectrum.
    """
    pieces = x if isinstance(x, list) else [x]
    d1, d2 = out_size
    m1, m2 = modes
    h, w_in = pieces[0].shape[-2:]
    if split is not None:
        h = split.n
    if m1 > d1 or m1 > h or m2 > d2 // 2 + 1 or m2 > w_in // 2 + 1:
        raise ValueError(
            f"modes {modes} incompatible with in {tuple(pieces[0].shape)} out {out_size}")
    if sum(p.shape[1] for p in pieces) != weights.shape[1]:
        raise ValueError(f"pieces of {[p.shape[1] for p in pieces]} channels for weights of "
                         f"{weights.shape[1]} in channels")

    w = torch.cat([weights[0], weights[1]], dim=2)  # (Ci, Co, 2*m1, m2)
    if split is not None:
        return _split_conv_2d(pieces, w, (d1, d2), (m1, m2), split)
    if _dft_enabled():
        return _DFTConv2d.apply(w, (d1, d2), (m1, m2), *pieces)
    return _fft_conv(pieces, w, (d1, d2), (m1, m2))


def _project_c2r(spec: torch.Tensor, n: int, axes: Tuple[int, ...], kept: int) -> torch.Tensor:
    """In place: the DC bin and, for an even ``n``, the Nyquist bin of the
    last axis of ``spec`` (where they lie among its first ``kept`` bins,
    the others being 0) replaced by their Hermitian part along ``axes``
    (none: by their real part).  Returns ``spec``."""
    for k in (0, n // 2) if n % 2 == 0 else (0,):
        if k >= kept:
            continue
        sl = spec[..., k]
        if not axes:
            torch.view_as_real(sl)[..., 1].zero_()
            continue
        # the index -i mod size on each axis: flip, then roll by one
        mirror = sl.flip(axes).roll([1] * len(axes), axes)
        sl.add_(mirror.conj_physical_()).mul_(0.5)
    return spec


class _HermitianC2R(torch.autograd.Function):
    """``_project_c2r`` as one autograd node: the projection is real-linear
    and self-adjoint, so its backward is itself."""

    @staticmethod
    def forward(ctx, spec, n, axes, kept):
        ctx.geometry = (n, axes, kept)
        ctx.mark_dirty(spec)
        return _project_c2r(spec, n, axes, kept)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _project_c2r(g.clone(), *ctx.geometry), None, None, None


def _hermitian_c2r(spec: torch.Tensor, n: int, axes: Tuple[int, ...] = (),
                   kept: Optional[int] = None) -> torch.Tensor:
    """``spec``, a fresh half spectrum for an ``n``-point c2r inverse along
    its last axis with nonzeros in its first ``kept`` bins (default: all),
    with its DC bin and, for an even ``n``, its Nyquist bin replaced in
    place by their Hermitian part along ``axes``, the slice axes still to be
    inverted by c2c transforms (none: by their real part)."""
    kept = spec.shape[-1] if kept is None else kept
    if torch.is_grad_enabled() and spec.requires_grad:
        return _HermitianC2R.apply(spec, n, tuple(axes), kept)
    return _project_c2r(spec, n, tuple(axes), kept)


def _irfft(spec: torch.Tensor, n: int, kept: int, norm: str) -> torch.Tensor:
    """``torch.fft.irfft(spec, n, norm=norm)`` of a fresh half spectrum with
    nonzeros in its first ``kept`` bins, taken as pocketfft takes it (the
    CPU, and so ``uno_tpu``): its DC and, for an even ``n``, Nyquist bins
    made real first (``_hermitian_c2r``), which cuFFT's c2r does not do by
    itself at every size (uno_s256's last block, 64 -> 256 points, left the
    CPU by rel-L2 1.0).  The split path's last inverse; the other paths
    fold the same rule into their remaps."""
    return torch.fft.irfft(_hermitian_c2r(spec, n, (), kept), n=n, norm=norm)


def _f32(x: torch.Tensor) -> torch.Tensor:
    """The FFT paths' compute dtype: f32, except that float64 stays float64
    (``gradcheck``)."""
    return x if x.dtype == torch.float64 else x.float()


def spectral_conv_1d(x: torch.Tensor, weights: torch.Tensor, out_size: int,
                     modes: int) -> torch.Tensor:
    """1D spectral conv.  x: (B, Ci, N) real -> (B, Co, out_size): f32 on
    the FFT path (float64 for a float64 x); on the DFT path bf16 for a bf16
    x, else f32.

    weights: (1, Ci, Co, modes) complex64, multiplying the first ``modes``
    bins of the rfft spectrum.
    """
    d1, m1 = out_size, modes
    if m1 > x.shape[-1] // 2 + 1 or m1 > d1 // 2 + 1:
        raise ValueError(f"modes1={m1} incompatible with input {x.shape[-1]} / output {d1}")
    if _dft_enabled():
        return _DFTConv1d.apply(x, weights[0], d1, m1)
    return _fft_conv([x], weights[0], (d1,), (m1,))


def _quadrants(weights: torch.Tensor) -> torch.Tensor:
    """The four (kx, ky) sign quadrants of a 3-D conv's (4, Ci, Co, m1, m2,
    m3) weights as one (Ci, Co, 2*m1, 2*m2, m3) block laid out [[(+,+),
    (+,-)], [(-,+), (-,-)]], in one copy (and its gradient in one)."""
    _, ci, co, m1, m2, m3 = weights.shape
    return (weights.reshape(2, 2, ci, co, m1, m2, m3).permute(2, 3, 1, 4, 0, 5, 6)
            .reshape(ci, co, 2 * m1, 2 * m2, m3))


@annotate("conv3d")
def spectral_conv_3d(
    x: torch.Tensor,
    weights: torch.Tensor,
    out_size: Tuple[int, int, int],
    modes: Tuple[int, int, int],
    split: Optional[Split] = None,
) -> torch.Tensor:
    """3D spectral conv.  x: (B, Ci, X, Y, T) real -> (B, Co, d1, d2, d3):
    f32 on the FFT path (float64 for a float64 x); on the DFT path bf16 for
    a bf16 x, else f32.  With ``split``, x holds its rows of an X =
    ``split.n`` grid and the result its rows of d1.

    weights: (4, Ci, Co, m1, m2, m3) complex64, the four (kx, ky) sign
    quadrants in the reference's order: (+,+), (-,+), (+,-), (-,-).
    """
    d1, d2, d3 = out_size
    m1, m2, m3 = modes
    sx, sy, st = x.shape[-3:]
    if split is not None:
        sx = split.n
    if m1 > d1 or m1 > sx or m2 > d2 or m2 > sy or m3 > d3 // 2 + 1 or m3 > st // 2 + 1:
        raise ValueError(f"modes {modes} incompatible with in {tuple(x.shape)} out {out_size}")

    if split is None and not _dft_enabled():
        return _fft_conv([x], _quadrants(weights), (d1, d2, d3), (m1, m2, m3))
    w_lo = torch.cat([weights[0], weights[2]], dim=3)
    w_hi = torch.cat([weights[1], weights[3]], dim=3)
    w = torch.cat([w_lo, w_hi], dim=2)  # (Ci, Co, 2*m1, 2*m2, m3)
    if split is not None:
        return _split_conv_3d(x, w, (d1, d2, d3), (m1, m2, m3), split)
    return _DFTConv3d.apply(x, w, (d1, d2, d3), (m1, m2, m3))


# --- the FFT path: cuFFT, remaps and the contraction ------------------------
#
# Each spectrum is laid out once in each direction by one remap
# (ops/kernels/remap.py), and the backward is written by hand: the adjoint
# of an r2c is a c2r of its gradient with the interior bins of the last axis
# halved, that of a c2r an r2c of its gradient with those bins doubled.
# Every transform runs unscaled (_r2c, _c2r), and each norm's factor is
# folded into the scale of the remap beside it, so no transform is followed
# by a pass over its output.  A remap that feeds a c2r takes the Hermitian
# part of the DC and Nyquist planes, so that every c2r plan answers as
# pocketfft does (the CPU, and so uno_tpu); the projection is self-adjoint,
# and the r2c output that a backward remap reads is Hermitian on those
# planes already, so a backward remap projects only where a c2r follows
# it.  A 1-D or 2-D spectrum is the remap's (B, C, 1, 1, N//2+1) or (B, C,
# 1, H, W//2+1): each leading axis of length 1 maps its one row to itself.


class _Plans(NamedTuple):
    """The remaps of one geometry: a conv's two each way (into and out of
    the contraction's block), a truncation's one each way (``fwd_in``,
    ``bwd_in``)."""

    fwd_in: remap_k.Plan
    fwd_out: Optional[remap_k.Plan]
    bwd_out: Optional[remap_k.Plan]
    bwd_in: remap_k.Plan


def _weight(k: int, n: int) -> int:
    """How often bin ``k`` of an ``n``-point half spectrum stands in the whole
    spectrum: once for DC and an even ``n``'s Nyquist bin, else twice."""
    return 1 if k == 0 or 2 * k == n else 2


def _c2r_planes(n: int) -> Tuple[int, ...]:
    """The bins of an ``n``-point c2r's half spectrum taken as real: DC and,
    for an even ``n``, Nyquist."""
    return (0, n // 2) if n % 2 == 0 else (0,)


def _kept(m: int, n: int) -> list:
    """A last-axis map of ``n`` bins: the first ``m`` read their own bin, the
    rest are 0."""
    return [k if k < m else None for k in range(n)]


def _dims(rank: int) -> Tuple[int, ...]:
    return tuple(range(-rank, 0))


def _r2c(x: torch.Tensor) -> torch.Tensor:
    """The unscaled rfftn of x (B, C, *grid) over its grid, as the remap's
    5-D spectrum."""
    spec = torch.fft.rfftn(x, dim=_dims(x.ndim - 2))
    return spec.reshape(spec.shape[:2] + (1,) * (5 - x.ndim) + spec.shape[2:])


def _c2r(spec: torch.Tensor, s: tuple) -> torch.Tensor:
    """The unscaled irfftn of a 5-D spectrum to the grid ``s``: (B, C, *s)."""
    y = torch.fft.irfftn(spec, s=s, dim=_dims(len(s)), norm="forward")
    return y.reshape(y.shape[:2] + tuple(s))


@lru_cache(maxsize=256)
def _conv_plans(grid: tuple, out_size: tuple, modes: tuple) -> _Plans:
    """The conv's remaps in 1, 2 or 3 dimensions: the corners of the
    input's half spectrum gathered into the (2*m1, 2*m2, m3) block (in 2-D
    (2*m1, m2), in 1-D (m1,); where 2*m > the input's length the corners
    overlap, and in the backward an input bin sums the block's two
    entries); the block scattered into the output's half spectrum, where 2*m
    > d the negative-frequency rows and columns written last winning, as in
    the reference (a positive row they overwrite gets no gradient).  The
    input's r2c takes the forward norm, 1 / (the grid's size), folded into
    the gather, and its adjoint the same."""
    n = math.prod(grid)

    def corners(s, m):  # block row -> the input row it reads
        return [(i if i < m else s - 2 * m + i,) for i in range(2 * m)]

    def sums(s, m):  # input row -> the block rows read from it
        return [(i,) * (i < m) + (2 * m - s + i,) * (i >= s - m) for i in range(s)]

    def placed(d, m):  # output row -> the block row written there last
        return [(2 * m - d + i,) if i >= d - m else (i,) * (i < m) for i in range(d)]

    def survivors(d, m):  # block row -> the output row that kept it
        return [(i,) * (i < d - m) for i in range(m)] + [(d - m + i,) for i in range(m)]

    # the two leading axes' maps (fwd_in, fwd_out, bwd_out, bwd_in), a
    # length-1 axis's first
    axes = [([(0,)],) * 4] * (3 - len(grid)) + [
        (corners(s, m), placed(d, m), survivors(d, m), sums(s, m))
        for s, d, m in zip(grid[:-1], out_size[:-1], modes[:-1])]
    (fi1, fo1, bo1, bi1), (fi2, fo2, bo2, bi2) = axes
    st, d3, m3 = grid[-1], out_size[-1], modes[-1]
    return _Plans(
        remap_k.plan(fi1, fi2, range(m3), scale=[1 / n] * m3),
        remap_k.plan(fo1, fo2, _kept(m3, d3 // 2 + 1), herm=_c2r_planes(d3)),
        remap_k.plan(bo1, bo2, range(m3), scale=[_weight(k, d3) for k in range(m3)]),
        remap_k.plan(bi1, bi2, _kept(m3, st // 2 + 1),
                     scale=[1 / (_weight(k, st) * n) for k in range(st // 2 + 1)],
                     herm=_c2r_planes(st)))


def _remapped(spec: torch.Tensor, plan: remap_k.Plan, direction: str) -> torch.Tensor:
    REMAPS[direction] += 1
    return remap_k.remap(spec, plan)


def _fft_conv(pieces: list, w: torch.Tensor, out_size: tuple, modes: tuple) -> torch.Tensor:
    """The FFT path of the 1-, 2- and 3-D convs: ``pieces`` (B, Ci_k, *grid)
    and ``w`` (Ci, Co, *block) -> (B, Co, *out_size)."""
    pieces = [_f32(p) for p in pieces]
    plans = _conv_plans(tuple(pieces[0].shape[2:]), out_size, modes)
    if torch.is_grad_enabled() and (w.requires_grad or any(p.requires_grad for p in pieces)):
        return _FFTConv.apply(w, out_size, plans, *pieces)
    return _conv_forward(pieces, w, out_size, plans)[0]


def _conv_forward(pieces, w, out_size, plans: _Plans) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FFT path's forward: (the output, the contraction's operand: the
    pieces' blocks of kept modes, joined)."""
    rank = len(out_size)
    xb = _join([_remapped(_counted(_r2c(p), "r2c", rank), plans.fwd_in, "forward")
                for p in pieces])
    out_ft = _remapped(complex_mode_matmul(xb, w), plans.fwd_out, "forward")
    return _counted(_c2r(out_ft, out_size), "c2r", rank), xb


class _FFTConv(torch.autograd.Function):
    """A conv on the FFT path as one node, in 1, 2 or 3 dimensions.  w:
    (Ci, Co, *block) complex; then the input's channel pieces (B, Ci_k,
    *grid) f32 (float64 for ``gradcheck``), Ci the sum of their Ci_k (one
    piece: the whole input).  Each piece gets its own r2c and gather, and
    the blocks are joined for one contraction.  The backward: the r2c of
    the gradient, its kept modes gathered (the c2r's interior bins
    doubled), the contraction's two gradients, the input's block split by
    piece, and each piece's modes scattered into its half spectrum (the
    r2c's interior bins halved) and one c2r."""

    @staticmethod
    def forward(ctx, w, out_size, plans, *pieces):
        y, xb = _conv_forward(pieces, w, out_size, plans)
        ctx.save_for_backward(xb, w)
        ctx.geometry = (plans, tuple(pieces[0].shape[2:]), [p.shape[1] for p in pieces])
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        xb, w = ctx.saved_tensors
        plans, grid, channels = ctx.geometry
        gb = _remapped(_r2c(g), plans.bwd_out, "backward")
        (b, co), ci = gb.shape[:2], w.shape[0]
        gxs = [None] * len(channels)
        if any(ctx.needs_input_grad[3:]):
            gxb = cmul_k.cmul_bwd_x(gb.reshape(b, co, -1), w.reshape(ci, co, -1)).reshape(xb.shape)
            gxs = [_c2r(_remapped(gxp, plans.bwd_in, "backward"), grid) if need else None
                   for gxp, need in zip(gxb.split(channels, dim=1), ctx.needs_input_grad[3:])]
        gw = None
        if ctx.needs_input_grad[0]:
            gw = cmul_k.cmul_bwd_w(xb.reshape(b, ci, -1), gb.reshape(b, co, -1)).reshape(w.shape)
        return gw, None, None, *gxs


@lru_cache(maxsize=256)
def _truncate_plans(grid: tuple, out_size: tuple) -> _Plans:
    """``fourier_truncate_3d``'s remap and its transpose: a bin is kept
    where it lies in the union of the four quadrant slices (m = d // 2 per
    axis, at the input's indices) and inside both grids' half spectra (the
    irfftn's trailing trim or zero pad); in time below d3 // 2, so the
    output's Nyquist bin is 0.  The c2r's backward norm, 1 / (d1 d2 d3), is
    folded into both."""
    (sx, sy, st), (d1, d2, d3) = grid, out_size
    n = d1 * d2 * d3

    def kept(s, d, n):  # index i of an n-long axis, kept or not
        m = d // 2
        return [(i,) * (i < min(s, d) and (i < m or i >= s - m)) for i in range(n)]

    nt = min(st // 2 + 1, d3 // 2)
    return _Plans(
        remap_k.plan(kept(sx, d1, d1), kept(sy, d2, d2), _kept(nt, d3 // 2 + 1),
                     scale=[1 / n] * (d3 // 2 + 1), herm=_c2r_planes(d3)),
        None, None,
        remap_k.plan(kept(sx, d1, sx), kept(sy, d2, sy), _kept(nt, st // 2 + 1),
                     scale=[_weight(k, d3) / (_weight(k, st) * n) for k in range(st // 2 + 1)],
                     herm=_c2r_planes(st)))


def _truncate3d_forward(x, out_size, plans: _Plans) -> torch.Tensor:
    spec = _remapped(_counted(_r2c(x), "r2c", 3), plans.fwd_in, "forward")
    return _counted(_c2r(spec, out_size), "c2r", 3)


class _FFTTruncate3d(torch.autograd.Function):
    """``fourier_truncate_3d`` on the FFT path as one node.  The map is
    linear, so the backward saves nothing: the r2c of the gradient, the
    transposed remap and one c2r."""

    @staticmethod
    def forward(ctx, x, out_size, plans):
        ctx.geometry = (plans, tuple(x.shape[-3:]))
        return _truncate3d_forward(x, out_size, plans)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        plans, grid = ctx.geometry
        return _c2r(_remapped(_r2c(g), plans.bwd_in, "backward"), grid), None, None


@annotate("truncate3d")
def fourier_truncate_3d(x: torch.Tensor, out_size: Tuple[int, int, int],
                        split: Optional[Split] = None) -> torch.Tensor:
    """Low-pass the spectrum as the reference's 3-D pointwise op does.  x:
    (B, C, X, Y, T) -> (B, C, d1, d2, d3): on the FFT path f32 whatever the
    input dtype (but float64); on the DFT path bf16 for a bf16 x, else f32.

    As in ``uno_tpu``, a reference quirk is kept: the default (backward)
    norm, an unnormalised rfftn and an irfftn that divides by the output
    size, unlike the forward-norm spectral conv.  The reference's four
    overlapping quadrant writes copy the spectrum into zeros at the same
    indices, so their net effect is a 0/1 mask over the union of the
    quadrant slices, ``m = d // 2`` per axis, at the input's indices; the
    irfftn to ``out_size`` then trims or zero-pads the trailing entries of
    each axis.  The FFT path applies both in one remap
    (``_truncate_plans``); the DFT path computes the same map from the kept
    bins alone (``_DFTTruncate3d``).  With ``split``, x holds its rows of
    an X = ``split.n`` grid and the result its rows of d1.
    """
    d1, d2, d3 = out_size
    if split is not None:
        return _split_truncate_3d(x, (d1, d2, d3), split)
    if _dft_enabled():
        return _DFTTruncate3d.apply(x, (d1, d2, d3))
    x = _f32(x)
    plans = _truncate_plans(tuple(x.shape[-3:]), (d1, d2, d3))
    if torch.is_grad_enabled() and x.requires_grad:
        return _FFTTruncate3d.apply(x, (d1, d2, d3), plans)
    return _truncate3d_forward(x, (d1, d2, d3), plans)


# --- the partial-DFT path -----------------------------------------------------


def _w_blocks(w: torch.Tensor) -> torch.Tensor:
    """2x2 block tensor of a complex weight: blk[p_in, q_out] with
    out_q = sum_p x_p @ blk[p, q].  Shape (2, 2, Ci, Co, *modes), real."""
    wr, wi = w.real, w.imag
    return torch.stack([torch.stack([wr, wi]), torch.stack([-wi, wr])])


def _blk_einsum(ein: str, a: torch.Tensor, blk: torch.Tensor) -> torch.Tensor:
    """bf16 operands with f32 accumulation and a bf16 output for a bf16
    ``a``; else f32 (float64 stays float64)."""
    dt = dft.compute_dtype(a.dtype)
    return torch.einsum(ein, a.to(dt), blk.to(dt))


def _cmul_planes(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Complex mode contraction on packed-plane data as one einsum.

    xp: (B, Ci, 2, *modes) (plane axis at dft.PLANE_AXIS); w: (Ci, Co,
    *modes) complex.  Returns (B, Co, 2, *modes): per-mode complex matmul
    over Ci, through a 2x2 block weight tensor so both output planes come
    out of one product.
    """
    ms = "xyz"[: w.ndim - 2]
    return _blk_einsum(f"aiu{ms},uvio{ms}->aov{ms}", xp, _w_blocks(w))


def _cmul_planes_t(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Transpose of ``_cmul_planes`` with respect to its input (same block
    tensor, contraction flipped)."""
    ms = "xyz"[: w.ndim - 2]
    return _blk_einsum(f"aov{ms},uvio{ms}->aiu{ms}", g, _w_blocks(w))


def _cmul_grad_w(xp: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Cotangent of ``_cmul_planes`` with respect to the complex weight, in
    torch's convention dL/dRe + i dL/dIm (``uno_tpu`` returns the conjugate,
    the JAX convention).

    f32 accumulation and an f32 result in both precisions: bf16 operands are
    widened first, which is exact (a product of two bf16 values fits in
    f32), so this is bf16 products summed in f32, as in ``uno_tpu``.
    """
    ms = "xyz"[: xp.ndim - 3]
    dt = torch.float64 if xp.dtype == torch.float64 else torch.float32
    gblk = torch.einsum(f"aiu{ms},aov{ms}->uvio{ms}", xp.to(dt), g.to(dt))
    dwr = gblk[0, 0] + gblk[1, 1]
    dwi = gblk[0, 1] - gblk[1, 0]
    return torch.complex(dwr, dwi)


def _keep_idx(m: int, d: int):
    """Output-spectrum row bookkeeping for one +/- mode axis: the positive
    block keeps its first min(m, d-m) rows (the reference's overlapping
    corner writes are last-write-wins), the FFT path's ``n_top``."""
    n_keep = min(m, d - m)
    return n_keep, tuple(range(n_keep)) + tuple(range(d - m, d))


def _slice_pm(out: torch.Tensor, axis: int, m: int, n_keep: int) -> torch.Tensor:
    """Keep rows [:n_keep] and [m:] of a +/- stacked mode axis."""
    lo = out.narrow(axis, 0, n_keep)
    hi = out.narrow(axis, m, m)
    return torch.cat([lo, hi], dim=axis)


def _unslice_pm(g: torch.Tensor, axis: int, m: int, n_keep: int) -> torch.Tensor:
    """Transpose of ``_slice_pm``: scatter kept-row cotangents back to the
    2m-row layout (dropped rows get zeros)."""
    ax = axis % g.ndim
    lo = g.narrow(ax, 0, n_keep)
    hi = g.narrow(ax, n_keep, g.shape[ax] - n_keep)
    if m - n_keep:
        shape = list(g.shape)
        shape[ax] = m - n_keep
        return torch.cat([lo, g.new_zeros(shape), hi], dim=ax)
    return torch.cat([lo, hi], dim=ax)


def _dft_in(x: torch.Tensor) -> torch.Tensor:
    """Compute dtype entering the DFT transforms: bf16 stays bf16 (the
    mixed-precision policy), float64 stays float64, anything else is f32."""
    return x.to(dft.compute_dtype(x.dtype))


def _rows(m1: int, h: int) -> tuple:
    """The kept input rows: the non-negative then the negative kx corner."""
    return tuple(range(m1)) + tuple(range(h - m1, h))


class _DFTConv2d(torch.autograd.Function):
    """The 2-D conv on the partial-DFT path (``uno_tpu``'s ``_dft_conv2d``).

    w: (Ci, Co, 2*m1, m2) complex, the two corner blocks stacked along kx;
    then the input's channel pieces (B, Ci_k, H, W), Ci the sum of their
    Ci_k (one piece: the whole input).  Each piece is transformed alone and
    their kept modes are joined for one contraction.  The backward is the
    mirrored chain of ``dft.t_*`` transposes, not autograd of the einsums:
    one gradient per piece in its dtype, and the weight's in torch's
    complex convention."""

    @staticmethod
    def forward(ctx, w, out_size, modes, *pieces):
        (d1, d2), (m1, m2) = out_size, modes
        h, w_in = pieces[0].shape[-2:]
        xps = [dft.fwd_cplx(dft.fwd_real(_dft_in(x), -2, h, _rows(m1, h)), -1, w_in, range(m2))
               for x in pieces]
        xp = _join(xps)  # (B, Ci, 2, 2*m1, m2)
        out = _cmul_planes(xp, w)  # (B, Co, 2, 2*m1, m2)
        n_top, idx_out = _keep_idx(m1, d1)
        yp = dft.inv_cplx(_slice_pm(out, -2, m1, n_top), -2, d1, idx_out)
        ctx.save_for_backward(xp, w)
        ctx.geometry = (out_size, modes, (h, w_in), [(x.shape[1], x.dtype) for x in pieces])
        return dft.inv_real(yp, -1, d2)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        xp, w = ctx.saved_tensors
        (d1, d2), (m1, m2), (h, w_in), pieces = ctx.geometry
        n_top, idx_out = _keep_idx(m1, d1)
        gyp = dft.t_inv_real(_dft_in(g), -1, m2, d2)
        gout = _unslice_pm(dft.t_inv_cplx(gyp, -2, d1, idx_out), -2, m1, n_top)
        gxs = [None] * len(pieces)
        if any(ctx.needs_input_grad[3:]):
            gxps = _cmul_planes_t(gout, w).split([c for c, _ in pieces], dim=1)
            gxs = [dft.t_fwd_real(dft.t_fwd_cplx(gxp, -1, w_in, range(m2)), -2, h,
                                  _rows(m1, h)).to(dt) if need else None
                   for gxp, (_, dt), need in zip(gxps, pieces, ctx.needs_input_grad[3:])]
        gw = _cmul_grad_w(xp, gout).to(w.dtype) if ctx.needs_input_grad[0] else None
        return gw, None, None, *gxs


class _DFTConv1d(torch.autograd.Function):
    """The 1-D conv on the partial-DFT path (``uno_tpu``'s ``_dft_conv1d``).

    x: (B, Ci, N); w: (Ci, Co, m1) complex.  The backward is the chain of
    ``dft.t_*`` transposes and returns the weight's gradient in torch's
    complex convention."""

    @staticmethod
    def forward(ctx, x, w, d1, m1):
        n = x.shape[-1]
        xp = dft.fwd_real(_dft_in(x), -1, n, range(m1))  # (B, Ci, 2, m1)
        ctx.save_for_backward(xp, w)
        ctx.geometry = (d1, m1, n, x.dtype)
        return dft.inv_real(_cmul_planes(xp, w), -1, d1)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        xp, w = ctx.saved_tensors
        d1, m1, n, xdtype = ctx.geometry
        gout = dft.t_inv_real(_dft_in(g), -1, m1, d1)
        gx = None
        if ctx.needs_input_grad[0]:
            gx = dft.t_fwd_real(_cmul_planes_t(gout, w), -1, n, range(m1)).to(xdtype)
        gw = _cmul_grad_w(xp, gout).to(w.dtype) if ctx.needs_input_grad[1] else None
        return gx, gw, None, None


class _DFTConv3d(torch.autograd.Function):
    """The 3-D conv on the partial-DFT path (``uno_tpu``'s ``_dft_conv3d``).

    x: (B, Ci, X, Y, T); w: (Ci, Co, 2*m1, 2*m2, m3) complex, the four
    quadrant blocks laid out as the FFT path's.  The time axis is
    transformed first (real to complex), then kx and ky at the kept rows;
    where 2*m > d the positive blocks keep their first d - m rows, as on
    the FFT path.  The backward is the mirrored chain of ``dft.t_*``
    transposes and returns the weight's gradient in torch's complex
    convention."""

    @staticmethod
    def forward(ctx, x, w, out_size, modes):
        (d1, d2, d3), (m1, m2, m3) = out_size, modes
        sx, sy, t_in = x.shape[-3:]
        xp = dft.fwd_real(_dft_in(x), -1, t_in, range(m3))
        xp = dft.fwd_cplx(xp, -3, sx, _rows(m1, sx))
        xp = dft.fwd_cplx(xp, -2, sy, _rows(m2, sy))  # (B, Ci, 2, 2*m1, 2*m2, m3)
        out = _cmul_planes(xp, w)
        (n_x, idx_x), (n_y, idx_y) = _keep_idx(m1, d1), _keep_idx(m2, d2)
        kept = _slice_pm(_slice_pm(out, -3, m1, n_x), -2, m2, n_y)
        yp = dft.inv_cplx(dft.inv_cplx(kept, -3, d1, idx_x), -2, d2, idx_y)
        ctx.save_for_backward(xp, w)
        ctx.geometry = (out_size, modes, (sx, sy, t_in), x.dtype)
        return dft.inv_real(yp, -1, d3)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        xp, w = ctx.saved_tensors
        (d1, d2, d3), (m1, m2, m3), (sx, sy, t_in), xdtype = ctx.geometry
        (n_x, idx_x), (n_y, idx_y) = _keep_idx(m1, d1), _keep_idx(m2, d2)
        gyp = dft.t_inv_real(_dft_in(g), -1, m3, d3)
        gkept = dft.t_inv_cplx(dft.t_inv_cplx(gyp, -2, d2, idx_y), -3, d1, idx_x)
        gout = _unslice_pm(_unslice_pm(gkept, -2, m2, n_y), -3, m1, n_x)
        gx = None
        if ctx.needs_input_grad[0]:
            gxp = dft.t_fwd_cplx(_cmul_planes_t(gout, w), -2, sy, _rows(m2, sy))
            gxp = dft.t_fwd_cplx(gxp, -3, sx, _rows(m1, sx))
            gx = dft.t_fwd_real(gxp, -1, t_in, range(m3)).to(xdtype)
        gw = _cmul_grad_w(xp, gout).to(w.dtype) if ctx.needs_input_grad[1] else None
        return gx, gw, None, None


def _truncate_bins(shape, out_size):
    """The kept bins of ``fourier_truncate_3d``'s DFT path per axis, at
    their original indices: the union of the quadrant slices (m = d // 2),
    filtered by the irfftn's trailing trim to the output length.  Negative
    frequencies are not relocated when the input is smaller than the
    output, as in the reference's backward-norm quirk."""
    (sx, sy, t_full), (d1, d2, d3) = shape, out_size
    m1, m2, m3 = d1 // 2, d2 // 2, d3 // 2
    kx = tuple(k for k in range(sx) if (k < m1 or k >= sx - m1) and k < d1)
    ky = tuple(k for k in range(sy) if (k < m2 or k >= sy - m2) and k < d2)
    kt = tuple(range(min(m3, t_full // 2 + 1, d3 // 2 + 1)))
    return kx, ky, kt


class _DFTTruncate3d(torch.autograd.Function):
    """``fourier_truncate_3d`` on the partial-DFT path (``uno_tpu``'s DFT
    branch): unscaled forward transforms at the kept bins, inverse
    transforms divided by the output sizes (the backward norm).  The map is
    linear, so the backward saves nothing: it is the chain of ``dft.t_*``
    transposes in reverse."""

    @staticmethod
    def forward(ctx, x, out_size):
        d1, d2, d3 = out_size
        sx, sy, t_full = x.shape[-3:]
        kx, ky, kt = _truncate_bins((sx, sy, t_full), out_size)
        xp = dft.fwd_real(_dft_in(x), -1, t_full, kt, scaled=False)
        xp = dft.fwd_cplx(xp, -3, sx, kx, scaled=False)
        xp = dft.fwd_cplx(xp, -2, sy, ky, scaled=False)
        yp = dft.inv_cplx(xp, -3, d1, kx, scaled=True)
        yp = dft.inv_cplx(yp, -2, d2, ky, scaled=True)
        ctx.geometry = (out_size, (sx, sy, t_full), x.dtype)
        return dft.inv_real(yp, -1, d3, scaled=True)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (d1, d2, d3), (sx, sy, t_full), xdtype = ctx.geometry
        kx, ky, kt = _truncate_bins((sx, sy, t_full), (d1, d2, d3))
        gp = dft.t_inv_real(_dft_in(g), -1, len(kt), d3, scaled=True)
        gp = dft.t_inv_cplx(gp, -2, d2, ky, scaled=True)
        gp = dft.t_inv_cplx(gp, -3, d1, kx, scaled=True)
        gp = dft.t_fwd_cplx(gp, -2, sy, ky, scaled=False)
        gp = dft.t_fwd_cplx(gp, -3, sx, kx, scaled=False)
        return dft.t_fwd_real(gp, -1, t_full, kt, scaled=False).to(xdtype), None


# --- the first grid axis split over ranks -------------------------------------


def _build_row_dft(n: int, bins: tuple, lo: int, hi: int, inverse: bool, scale: float,
                   dtype: torch.dtype, device) -> torch.Tensor:
    """The DFT of rows ``[lo, hi)`` of an ``n``-point axis at ``bins``:
    ``scale * e^{-2 pi i k j / n}`` as (len(bins), hi - lo), or with
    ``inverse`` ``scale * e^{+2 pi i k j / n}`` as (hi - lo, len(bins));
    complex ``dtype``.  Built outside inference mode (a later backward may
    save it)."""
    k = np.asarray(bins, np.int64)[:, None]
    j = np.arange(lo, hi, dtype=np.int64)[None, :]
    t = np.exp((1j if inverse else -1j) * 2.0 * np.pi * ((k * j) % n) / n) * scale
    with torch.inference_mode(False):
        return torch.from_numpy(np.ascontiguousarray(t.T if inverse else t)).to(
            device=device, dtype=dtype)


# built once per process; while torch.export traces, tensors are fake, and a
# table built then is not cached (the trace records it as a constant)
_cached_row_dft = lru_cache(maxsize=256)(_build_row_dft)


def _row_dft(*args) -> torch.Tensor:
    build = _build_row_dft if torch.compiler.is_exporting() else _cached_row_dft
    return build(*args)


def _fwd_rows(x: torch.Tensor, split: Split, bins, scale: float) -> torch.Tensor:
    """This rank's part of the DFT of axis 2 at ``bins``: x (B, C, rows, ...)
    complex -> (B, C, len(bins), ...)."""
    lo, hi = split.rows()
    t = _row_dft(split.n, tuple(bins), lo, hi, False, scale, x.dtype, x.device)
    return torch.einsum("kj,bcj...->bck...", t, x)


def _inv_rows(x: torch.Tensor, split: Split, bins, scale: float) -> torch.Tensor:
    """The inverse DFT of axis 2 from ``bins`` (others zero) at this rank's
    output rows: (B, C, len(bins), ...) -> (B, C, rows, ...)."""
    lo, hi = split.rows()
    t = _row_dft(split.n, tuple(bins), lo, hi, True, scale, x.dtype, x.device)
    return torch.einsum("jk,bck...->bcj...", t, x)


def _split_conv_2d(pieces, w, out_size, modes, split: Split) -> torch.Tensor:
    """``spectral_conv_2d`` with H split: the W transform locally, the kept
    kx rows of H from each rank's rows of each channel piece, joined over
    the pieces, summed over the ranks, contracted, inverted at the rank's
    d1 rows."""
    (d1, d2), (m1, m2) = out_size, modes
    h, w_in = split.n, pieces[0].shape[-1]
    n_top, idx_out = _keep_idx(m1, d1)
    out_rows = split.at(d1).rows()
    if _dft_enabled():
        xp = _join([dft.fwd_cplx(dft.fwd_real(_dft_in(x), -1, w_in, range(m2)), -2, h,
                                 _rows(m1, h), rows=split.rows())
                    for x in pieces])  # (B, Ci, 2, 2*m1, m2)
        out = _cmul_planes(psum(xp, split.group), w)
        yp = dft.inv_cplx(_slice_pm(out, -2, m1, n_top), -2, d1, idx_out, rows=out_rows)
        return dft.inv_real(yp, -1, d2)
    corners = _join([_fwd_rows(torch.fft.rfft(_f32(x), dim=-1, norm="forward")[..., :m2],
                               split, _rows(m1, h), 1.0 / h) for x in pieces])
    out = complex_mode_matmul(psum(corners, split.group), w)  # (B, Co, 2*m1, m2)
    y = _inv_rows(_slice_pm(out, 2, m1, n_top), split.at(d1), idx_out, 1.0)
    return _irfft(y, d2, m2, "forward")


def _split_conv_3d(x, w, out_size, modes, split: Split) -> torch.Tensor:
    """``spectral_conv_3d`` with X split: T and Y transformed locally (kept
    bins only), the kept kx rows from each rank's rows, summed, contracted,
    inverted at the rank's d1 rows, then Y and T."""
    (d1, d2, d3), (m1, m2, m3) = out_size, modes
    sx, (sy, st) = split.n, x.shape[-2:]
    (n_x, idx_x), (n_y, idx_y) = _keep_idx(m1, d1), _keep_idx(m2, d2)
    if _dft_enabled():
        xp = dft.fwd_real(_dft_in(x), -1, st, range(m3))
        xp = dft.fwd_cplx(xp, -2, sy, _rows(m2, sy))
        xp = dft.fwd_cplx(xp, -3, sx, _rows(m1, sx), rows=split.rows())
        out = _cmul_planes(psum(xp, split.group), w)
        kept = _slice_pm(_slice_pm(out, -3, m1, n_x), -2, m2, n_y)
        yp = dft.inv_cplx(kept, -3, d1, idx_x, rows=split.at(d1).rows())
        return dft.inv_real(dft.inv_cplx(yp, -2, d2, idx_y), -1, d3)
    xf = torch.fft.fft(torch.fft.rfft(_f32(x), dim=-1, norm="forward")[..., :m3],
                       dim=-2, norm="forward")
    xf = torch.cat([xf[..., :m2, :], xf[..., sy - m2 :, :]], dim=-2)
    corners = psum(_fwd_rows(xf, split, _rows(m1, sx), 1.0 / sx), split.group)
    out = complex_mode_matmul(corners, w)  # (B, Co, 2*m1, 2*m2, m3)
    y = _inv_rows(_slice_pm(out, 2, m1, n_x), split.at(d1), idx_x, 1.0)
    b, co, r = y.shape[:3]
    out_ft = torch.zeros((b, co, r, d2, d3 // 2 + 1), dtype=y.dtype, device=y.device)
    out_ft[..., :n_y, :m3] = y[..., :n_y, :]
    out_ft[..., d2 - m2 :, :m3] = y[..., m2:, :]
    return _irfft(torch.fft.ifft(out_ft, dim=-2, norm="forward"), d3, m3, "forward")


def _split_truncate_3d(x, out_size, split: Split) -> torch.Tensor:
    """``fourier_truncate_3d`` with X split: the kept bins of T and Y
    locally, of X from each rank's rows, summed, inverted at the rank's d1
    rows (backward norm, the kept bins at their input indices)."""
    d1, d2, d3 = out_size
    sx, (sy, st) = split.n, x.shape[-2:]
    kx, ky, kt = _truncate_bins((sx, sy, st), out_size)
    out_rows = split.at(d1).rows()
    if _dft_enabled():
        xp = dft.fwd_real(_dft_in(x), -1, st, kt, scaled=False)
        xp = dft.fwd_cplx(xp, -2, sy, ky, scaled=False)
        xp = dft.fwd_cplx(xp, -3, sx, kx, scaled=False, rows=split.rows())
        yp = dft.inv_cplx(psum(xp, split.group), -3, d1, kx, scaled=True,
                          rows=out_rows)
        return dft.inv_real(dft.inv_cplx(yp, -2, d2, ky, scaled=True), -1, d3, scaled=True)
    ft = torch.fft.fft(torch.fft.rfft(_f32(x), dim=-1)[..., : len(kt)], dim=-2)[..., list(ky), :]
    y = _inv_rows(psum(_fwd_rows(ft, split, kx, 1.0), split.group), split.at(d1),
                  kx, 1.0 / d1)
    b, c, r = y.shape[:3]
    spec = torch.zeros((b, c, r, d2, d3 // 2 + 1), dtype=y.dtype, device=y.device)
    spec[..., list(ky), : len(kt)] = y
    return _irfft(torch.fft.ifft(spec, dim=-2), d3, len(kt), "backward")
