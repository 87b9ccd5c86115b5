"""Config-driven U-NO model core (port of ``uno_tpu/models/core.py``).

Every U-NO variant is a declarative ``UNOSpec``: an ordered tuple of
``BlockSpec`` entries whose output grid is an exact rational multiple of the
padded base grid, plus lift/projection/padding/embedding choices.
``UNOModel`` interprets a spec.  The spec dataclasses are framework-free
copies of ``uno_tpu``'s (tests/test_torch_guards.py holds them field-for-field
equal); grid arithmetic uses ``fractions.Fraction`` floors, exactly.

Only 2-D specs are ported; a 3-D spec raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction
from typing import Optional, Tuple

import torch
from torch import nn

from uno_tpu_torch.models.embeddings import EMBEDDINGS
from uno_tpu_torch.nn.layers import Dense, OperatorBlock, gelu
from uno_tpu_torch.ops.kernels.mlp_head import mlp_head

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
    remat_blocks: bool = False         # uno_tpu: jax.checkpoint each block
    # round padded grid sizes up to a multiple (extra zeros on the trailing
    # edge, cropped exactly)
    pad_to: Optional[int] = None


def _scale(d: int, f: Fraction) -> int:
    return (d * f.numerator) // f.denominator


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class UNOModel(nn.Module):
    """Interpreter for a 2-D UNOSpec.  Input and output are channels-last:
    (B, S1, S2, C) -> (B, S1, S2, out_dim).

    Parameters are drawn from ``generator`` on the CPU and moved to
    ``device``.  It trains under autograd: the spectral contraction and the
    fused head are ``torch.autograd.Function``s whose backward passes are
    kernels too.  Under ``torch.no_grad()`` or ``torch.inference_mode()``
    they run forward only and save nothing.
    """

    def __init__(self, spec: UNOSpec, device=None,
                 generator: torch.Generator = None):
        super().__init__()
        if spec.ndim != 2:
            raise NotImplementedError(
                f"{spec.name}: {spec.ndim}-D models are not ported yet "
                "(ROADMAP.md, Queue 1: NS-3D)"
            )
        if spec.pad_mode not in ("darcy", "sym", "end"):
            raise ValueError(f"{spec.name}: pad_mode {spec.pad_mode!r} is not a 2-D mode")
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

    def _pads(self, size: Tuple[int, int]):
        """Per spatial axis (lo, hi) padding of the lifted field."""
        spec = self.spec
        if spec.pad_mode == "darcy":
            # right/bottom by ceil(S/85)*pad, from the last axis' size
            p = math.ceil(size[-1] / spec.darcy_base) * spec.pad
            pads = [(0, p), (0, p)]
        elif spec.pad_mode == "sym":
            pads = [(spec.pad, spec.pad)] * 2
        else:  # 'end': one-sided right/bottom padding
            pads = [(0, spec.pad)] * 2
        if spec.pad_to:
            pads = [
                (lo, hi + (-(n + lo + hi)) % spec.pad_to)
                for n, (lo, hi) in zip(size, pads)
            ]
        return pads

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        if x.ndim != 4:
            raise ValueError(f"{spec.name}: expected (B, S1, S2, C), got {tuple(x.shape)}")
        grid = EMBEDDINGS[spec.embed](x.shape, x.device)
        x = torch.cat([x.float(), grid], dim=-1)
        if x.shape[-1] != spec.in_width:
            raise ValueError(
                f"{spec.name}: in_width={spec.in_width} but data+embedding "
                f"supply {x.shape[-1]} channels ({grid.shape[-1]} from "
                f"'{spec.embed}')"
            )

        h = gelu(self.fc(x))
        v = gelu(self.fc0(h)).movedim(-1, 1)  # channels-first

        orig = tuple(v.shape[2:])
        pads = self._pads(orig)
        (lo1, hi1), (lo2, hi2) = pads
        if lo1 or hi1 or lo2 or hi2:
            v = torch.nn.functional.pad(v, (lo2, hi2, lo1, hi1))
        base = v.shape[2:]

        # U-stack.  Skips are materialized with torch.cat, except after the
        # last block, whose pieces are cropped first and concatenated at the
        # cropped grid (one copy instead of concat + crop).
        outs = []
        cur = v
        last = len(spec.blocks) - 1
        for i, blk in enumerate(spec.blocks):
            out_size = tuple(_scale(d, g) for d, g in zip(base, blk.grid))
            cur = getattr(self, f"block{i}")(cur, out_size)
            if blk.skip is not None:
                src = v if blk.skip == LIFT else outs[blk.skip]
                cur = [cur, src] if i == last else torch.cat([cur, src], dim=1)
            outs.append(cur)

        # crop the padding
        s1, s2 = orig
        pieces = cur if isinstance(cur, list) else [cur]
        if any(p.shape[-2:] != (s1, s2) for p in pieces):
            pieces = [p[..., lo1 : lo1 + s1, lo2 : lo2 + s2] for p in pieces]
        cur = torch.cat(pieces, dim=1) if len(pieces) > 1 else pieces[0]

        # projection head: f32 weights, dots, GELU and output; only the input
        # may be bf16.  Under bf16 it is the fused kernel.
        if self.dtype == torch.bfloat16 and not spec.proj_concat_lift:
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
