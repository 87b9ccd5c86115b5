"""Config-driven U-NO model core (port of ``uno_tpu/models/core.py``).

Every U-NO variant is a declarative ``UNOSpec``: an ordered tuple of
``BlockSpec`` entries whose output grid is an exact rational multiple of the
padded base grid, plus lift/projection/padding/embedding choices.
``UNOModel`` interprets a spec.  The spec dataclasses are framework-free
copies of ``uno_tpu``'s (tests/test_torch_guards.py holds them field-for-field
equal); grid arithmetic uses ``fractions.Fraction`` floors, exactly.

2-D specs (Darcy, NS-2D) and 3-D specs (NS-3D: space contracts through the
encoder while the time axis expands through the decoder) are interpreted,
as in ``uno_tpu``, whose model has no 1-D padding mode and so no 1-D spec;
the 1-D operator layers are in ``nn/layers.py``.

Skip concats: a 2-D model carries each one as a list of channel pieces
``[block output, skip source]`` (``fused_skips``), as ``uno_tpu`` carries
its tuples.  The next block's spectral conv and 1x1 conv take each piece
against its own input rows of their weights, so the concatenated
activation is never written; only the last block's pieces are
concatenated, after the crop.  As in ``uno_tpu`` this is on under f32 and
off under bf16, where the skips are materialized with ``torch.cat``;
``UNO_TPU_TORCH_FUSED_SKIPS=1`` and ``UNO_TPU_TORCH_NO_FUSED_SKIPS=1``
force either way, read at each forward.  3-D models never fuse.  Both
forms have the same parameters.

``remat_blocks`` runs each OperatorBlock under non-reentrant
``torch.utils.checkpoint`` when grad is on (``uno_tpu``'s ``nn.checkpoint``):
the forward keeps each block's input, the backward recomputes the block.
The recompute runs the same kernels on the same inputs, so the numbers are
the same bits.

Under the mesh's ``spatial`` axis (``uno_tpu_torch/parallel``) the model
runs split (``forward(x, split=)``: each rank holds its rows of the first
grid axis; ``input_rows`` says which) or, after ``parallel/tp.py``
``shard_state_tp``, channel tensor parallel (the layers gather what they
shard; the head then always takes the unfused Dense pair, since fc1's
hidden axis is sharded).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from fractions import Fraction
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from uno_tpu_torch.models.embeddings import EMBEDDINGS
from uno_tpu_torch.nn.layers import Dense, OperatorBlock, gelu
from uno_tpu_torch.ops.kernels.mlp_head import fused_head_enabled, mlp_head
from uno_tpu_torch.ops.resample import resize
from uno_tpu_torch.parallel.spatial import Axis, Split
from uno_tpu_torch.utils.profiling import annotate

LIFT = -1  # skip source: the padded lift output x_fc0


@dataclass(frozen=True)
class BlockSpec:
    channels: int                      # output co-domain dimension
    grid: Tuple[Fraction, ...]         # per-axis multiple of the padded grid
    modes: Tuple[int, ...]
    normalize: bool = False
    residual: bool = False
    skip: Optional[int] = None         # concat source after this block


@dataclass(frozen=True)
class UNOSpec:
    name: str
    ndim: int                          # spatial dims (2 or 3)
    in_width: int                      # input channels incl. grid embedding
    width: int
    lift_hidden: int
    embed: str                         # key into EMBEDDINGS
    pad: int
    pad_mode: str                      # 'darcy' | 'sym' | 'end' | 'time'
    blocks: Tuple[BlockSpec, ...]
    proj_hidden: int
    proj_concat_lift: bool = False
    out_dim: int = 1
    pad_both: bool = False             # 3D time padding on both sides
    crop_mult: Fraction = Fraction(1)  # 3D: time-crop = floor(crop_mult*pad)
    darcy_base: int = 85               # darcy pad scale = ceil(S/darcy_base)
    # mixed-precision policy: 'bfloat16' runs pointwise/lift matmuls and
    # inter-block activations in bf16 with f32 accumulation; FFTs, spectral
    # weights, norm statistics and the projection head stay f32.
    dtype: str = "float32"
    remat_blocks: bool = False         # checkpoint each operator block
    # round padded grid sizes up to a multiple (extra zeros on the trailing
    # edge, cropped exactly)
    pad_to: Optional[int] = None


def fused_skips(ndim: int, dtype: torch.dtype) -> bool:
    """Whether a model carries its skip concats as channel pieces:
    ``uno_tpu``'s gate, 2-D only, off under bf16 unless
    ``UNO_TPU_TORCH_FUSED_SKIPS=1``; ``UNO_TPU_TORCH_NO_FUSED_SKIPS=1`` turns
    it off everywhere."""
    if ndim != 2 or os.environ.get("UNO_TPU_TORCH_NO_FUSED_SKIPS") == "1":
        return False
    return dtype != torch.bfloat16 or os.environ.get("UNO_TPU_TORCH_FUSED_SKIPS") == "1"


def _scale(d: int, f: Fraction) -> int:
    return (d * f.numerator) // f.denominator


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_PAD_MODES = {2: ("darcy", "sym", "end"), 3: ("time",)}


class UNOModel(nn.Module):
    """Interpreter for a 2-D or 3-D UNOSpec.  Input and output are
    channels-last:

    * 2-D: (B, S1, S2, C) -> (B, S1, S2, out_dim)
    * 3-D: (B, S1, S2, T, C) -> (B, S1, S2, T_out, out_dim)

    Parameters are drawn from ``generator`` on the CPU and moved to
    ``device``.  It trains under autograd: the spectral contraction and the
    fused head are ``torch.autograd.Function``s whose backward passes are
    kernels too.  Under ``torch.no_grad()`` or ``torch.inference_mode()``
    they run forward only and save nothing.
    """

    def __init__(self, spec: UNOSpec, device=None,
                 generator: torch.Generator = None):
        super().__init__()
        if spec.ndim not in _PAD_MODES:
            raise NotImplementedError(
                f"{spec.name}: uno_tpu's UNOModel interprets 2-D and 3-D specs only, not "
                f"{spec.ndim}-D (the 1-D operator layers are in nn/layers.py)"
            )
        if spec.pad_mode not in _PAD_MODES[spec.ndim]:
            raise ValueError(
                f"{spec.name}: pad_mode {spec.pad_mode!r} is not a {spec.ndim}-D mode")
        self.spec = spec
        self.dtype = _DTYPES[spec.dtype]
        dt, dev, g = self.dtype, device, generator
        self.fc = Dense(spec.in_width, spec.lift_hidden, dt, dev, g)
        self.fc0 = Dense(spec.lift_hidden, spec.width, dt, dev, g)
        chans = []  # channels of each block's output, after its skip concat
        cur = spec.width
        for i, blk in enumerate(spec.blocks):
            self.add_module(
                f"block{i}",
                OperatorBlock(cur, blk.channels, blk.modes, blk.normalize,
                              blk.residual, dt, dev, g),
            )
            cur = blk.channels
            if blk.skip is not None:
                cur += spec.width if blk.skip == LIFT else chans[blk.skip]
            chans.append(cur)
        # the head runs in f32 under every policy (uno_tpu models/core.py)
        head_in = spec.proj_hidden + (spec.lift_hidden if spec.proj_concat_lift else 0)
        self.fc1 = Dense(cur, spec.proj_hidden, torch.float32, dev, g)
        self.fc2 = Dense(head_in, spec.out_dim, torch.float32, dev, g)

    def _pads(self, size: Tuple[int, ...]):
        """Per spatial axis (lo, hi) padding of the lifted field."""
        spec = self.spec
        if spec.pad_mode == "darcy":
            # right/bottom by ceil(S/85)*pad, from the last axis' size
            p = math.ceil(size[-1] / spec.darcy_base) * spec.pad
            pads = [(0, p), (0, p)]
        elif spec.pad_mode == "sym":
            pads = [(spec.pad, spec.pad)] * 2
        elif spec.pad_mode == "end":  # one-sided right/bottom padding
            pads = [(0, spec.pad)] * 2
        else:  # 'time': int(pad * 0.1 * T) on the time axis, as uno_tpu computes it
            p = int(spec.pad * 0.1 * size[-1])
            pads = [(0, 0)] * (len(size) - 1) + [(p, p) if spec.pad_both else (0, p)]
        if spec.pad_to:
            # 3-D models round only the time axis
            pads = [
                (lo, hi + (-(n + lo + hi)) % spec.pad_to)
                if spec.pad_mode != "time" or ax == len(size) - 1 else (lo, hi)
                for ax, (n, (lo, hi)) in enumerate(zip(size, pads))
            ]
        return pads

    def input_rows(self, size: Tuple[int, ...], axis: Axis) -> Tuple[int, int]:
        """The rows [lo, hi) of the first grid axis of an input of global
        spatial ``size`` that rank ``axis.rank`` holds when the model runs
        split: the input's rows that fall in the rank's rows of the padded
        grid (``parallel/spatial.py``), so that padding and cropping move
        nothing between ranks and the bottom pad rows belong to the last
        ranks."""
        (lo_pad, hi_pad), n = self._pads(tuple(size))[0], size[0]
        a, b = axis.split(lo_pad + n + hi_pad).rows()
        return min(max(a - lo_pad, 0), n), min(max(b - lo_pad, 0), n)

    def _crop(self, pieces, orig, pads, rows=None):
        """The padding cropped from each channel piece: the padded cells in
        2-D (``rows``: the rank's output rows of the first axis, split);
        ``floor(crop_mult * pad)`` of each padded side of the time axis in
        3-D (the time axis grows through the blocks)."""
        if self.spec.ndim == 2:
            (lo1, _), (lo2, _) = pads
            s1, s2 = orig
            if rows is not None:  # a, b: the rank's padded rows; keep the data ones
                (a, b), lo, hi = rows
                r0, r1 = lo + lo1 - a, hi + lo1 - a
                return [p[..., r0:r1, lo2 : lo2 + s2] for p in pieces]
            if any(p.shape[-2:] != (s1, s2) for p in pieces):
                pieces = [p[..., lo1 : lo1 + s1, lo2 : lo2 + s2] for p in pieces]
            return pieces
        lo, hi = pads[-1]
        c_lo, c_hi = _scale(lo, self.spec.crop_mult), _scale(hi, self.spec.crop_mult)
        if c_lo or c_hi:
            pieces = [p[..., c_lo : p.shape[-1] - c_hi] for p in pieces]
        return pieces

    @annotate("forward")
    def forward(self, x: torch.Tensor, split: Optional[Split] = None) -> torch.Tensor:
        """``split``: the ranks of the mesh's spatial axis when x holds this
        rank's rows ``input_rows(size, split)`` of the first grid axis, its
        global length given by ``split.n`` (a ``Split``); the output holds
        the same rows.  A call is one ``forward`` span."""
        spec = self.spec
        if x.ndim != spec.ndim + 2:
            raise ValueError(f"{spec.name}: expected a {spec.ndim + 2}-D channels-last input, "
                             f"got {tuple(x.shape)}")
        size = tuple(x.shape[1:-1]) if split is None else (split.n, *x.shape[2:-1])
        rows = None if split is None else self.input_rows(size, split)
        if rows is not None and x.shape[1] != rows[1] - rows[0]:
            raise ValueError(f"{spec.name}: rank {split.rank} of {split.world} holds rows "
                             f"{rows} of {size[0]}, got {x.shape[1]}")
        grid = EMBEDDINGS[spec.embed]((x.shape[0], *size), x.device, rows)
        x = torch.cat([x.float(), grid], dim=-1)
        if x.shape[-1] != spec.in_width:
            raise ValueError(
                f"{spec.name}: in_width={spec.in_width} but data+embedding "
                f"supply {x.shape[-1]} channels ({grid.shape[-1]} from "
                f"'{spec.embed}')"
            )

        h = gelu(self.fc(x))
        v = gelu(self.fc0(h)).movedim(-1, 1)  # channels-first

        pads = self._pads(size)
        base = tuple(lo + n + hi for n, (lo, hi) in zip(size, pads))
        local_pads, padded_rows = pads, None
        if split is not None:
            # this rank's padded rows [a, b): its data rows plus the pad rows
            # that fall in them (zeros), the other axes padded as usual
            padded_rows = split.split(base[0]).rows()
            top = max(0, min(padded_rows[1], pads[0][0]) - padded_rows[0])
            local_pads = [(top, padded_rows[1] - padded_rows[0] - top - v.shape[2])] + pads[1:]
        if any(lo or hi for lo, hi in local_pads):
            v = torch.nn.functional.pad(v, [n for lo_hi in reversed(local_pads) for n in lo_hi])

        # U-stack.  With fused_skips a skip block's output is the list of
        # its channel pieces; else it is concatenated, except after the last
        # block, whose pieces are always cropped first and concatenated at
        # the cropped grid (one copy instead of concat + crop).  3-D skip
        # sources are resized trilinearly to the current grid first.
        fuse = fused_skips(spec.ndim, self.dtype)
        outs = []
        cur, n_cur = v, base[0]  # n_cur: the global rows of cur's first grid axis
        last = len(spec.blocks) - 1
        grad = torch.is_grad_enabled()
        for i, blk in enumerate(spec.blocks):
            out_size = tuple(_scale(d, g) for d, g in zip(base, blk.grid))
            block = getattr(self, f"block{i}")
            sp = None if split is None else split.split(n_cur)
            if spec.remat_blocks and grad:
                # no random ops in a block: no RNG state to keep for the recompute
                cur = checkpoint(block, cur, out_size, sp, use_reentrant=False,
                                 preserve_rng_state=False)
            else:
                cur = block(cur, out_size, sp)
            n_cur = out_size[0]
            if blk.skip is not None:
                src = v if blk.skip == LIFT else outs[blk.skip]
                if isinstance(src, list):  # a skipped block's own pieces
                    src = torch.cat(src, dim=1)
                if spec.ndim == 3:
                    src_grid = Fraction(1) if blk.skip == LIFT else spec.blocks[blk.skip].grid[0]
                    with annotate("skip_resize"):
                        src = resize(src, (n_cur, *cur.shape[3:]), (2, 3, 4), "linear", True,
                                     False, None if split is None
                                     else split.split(_scale(base[0], src_grid)))
                cur = [cur, src] if fuse or i == last else torch.cat([cur, src], dim=1)
            outs.append(cur)

        if split is not None and n_cur != base[0]:
            raise NotImplementedError(f"{spec.name}: a split run needs the last block at the "
                                      f"padded grid's {base[0]} rows, not {n_cur}")
        crop_rows = None if split is None else (padded_rows, *rows)
        pieces = self._crop(cur if isinstance(cur, list) else [cur], size, pads, crop_rows)
        cur = torch.cat(pieces, dim=1) if len(pieces) > 1 else pieces[0]

        # projection head: f32 weights, dots, GELU and output; only the input
        # may be bf16.  Under bf16 a 2-D model runs the fused kernel unless
        # the head switch is off (or fc1 is sharded under TP); a 3-D model
        # always takes the unfused f32 Dense pair, as in uno_tpu.
        if (self.dtype == torch.bfloat16 and spec.ndim == 2 and not spec.proj_concat_lift
                and self.fc1.tp is None and fused_head_enabled()):
            out = mlp_head(
                cur.to(torch.bfloat16).contiguous(),
                self.fc1.weight.t().contiguous(), self.fc1.bias,
                self.fc2.weight.t().contiguous(), self.fc2.bias,
            )
            return out.movedim(1, -1)
        y = gelu(self.fc1(cur.movedim(1, -1)))
        if spec.proj_concat_lift:
            y = torch.cat([y, h.float()], dim=-1)
        return self.fc2(y)
