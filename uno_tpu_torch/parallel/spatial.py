"""Spatial domain decomposition and the model axis's collectives (port of
the ``spatial`` axis of ``uno_tpu/parallel/mesh.py``; under channel tensor
parallelism, ``parallel/tp.py``, the same axis carries weight shards).

``uno_tpu`` shards the leading grid axis over the ``spatial`` mesh axis and
lets GSPMD insert the collectives.  Here each rank of the axis is one
process that holds its rows of every activation, and the ops that couple
rows call the collectives below themselves:

* the spectral convs and the 3-D truncation (``ops/spectral.py``): a
  partial DFT of the rank's own rows, one ``psum`` of the kept
  modes, the inverse for the rank's own output rows;
* ``resize`` along the split axis (``ops/resample.py``): ``gather_rows`` of
  the band of input rows that the rank's output rows read;
* ``instance_norm`` (``ops/norm.py``) and ``relative_lp_loss``
  (``losses.py``): ``psum`` of their per-rank sums.

**The row partition.**  A split axis of ``n`` rows over ``world`` ranks
gives rank ``r`` the rows ``[r*n // world, (r+1)*n // world)``
(``partition``), at every resolution the model passes through.  It takes
any ``n >= world``; ``n`` need not divide: darcy_s211's padded 247 rows
over 2 ranks are 123 + 124, over 4 ranks 61 + 62 + 62 + 62.  The model's
input is the exception: a rank holds the rows of the input that fall in its
rows of the padded grid (``UNOModel.input_rows``), so the bottom pad rows
belong to the last ranks and nothing is moved between ranks to pad or crop.

**The invariant.**  A step's loss and every updated weight equal the
one-process step on the global batch.  It holds by three rules:

1. Every collective is differentiated by its exact adjoint: the backward of
   ``psum`` is ``psum``; the backward of ``gather_rows``
   and ``gather_channels`` sums each cotangent row back into the rank that
   holds that row.  So the cotangent of every value that a rank holds in
   part (its rows, its channel shard) is exact.
2. A value that every rank of the axis computes whole is counted once: the
   loss is made whole on every rank (its per-sample sums are all-reduced)
   and ``count_once`` seeds the backward with it on the axis's rank 0 and
   with zero elsewhere.  So the model's replicated tail (under TP, the
   unsharded ``out_dim = 1`` projection) gives its gradient on rank 0 only.
3. Then every gradient of a parameter that the ranks of the axis hold
   whole (every parameter under the spatial split; the unsharded ones under
   TP) is summed over the axis, and a sharded parameter keeps its own
   (``dp_value_and_grad``).  Under the split each rank's gradient is the
   part from its own rows: the contraction runs on the same reduced modes on
   every rank, but its cotangent comes from the rank's own output rows, so
   its weight gradient is a part too and is summed with the rest.

These are pinned in float64 by ``tests/test_torch_spatial.py``: each split
op and its gradients against the unsplit op within 1e-10.

Only ``all_reduce`` and ``broadcast`` are used.  Both run on NCCL and on
gloo, for CPU tensors and for CUDA ones (gloo stages a CUDA tensor through
the host), so two ranks can share one card over gloo.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, List, Tuple

import torch
import torch.distributed as dist


def partition(n: int, world: int, rank: int) -> Tuple[int, int]:
    """Rank ``rank``'s rows ``[lo, hi)`` of an axis of ``n`` rows over
    ``world`` ranks."""
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"rank {rank} of a world of {world}")
    if n < world:
        raise ValueError(f"an axis of {n} rows does not split over {world} ranks")
    return rank * n // world, (rank + 1) * n // world


@dataclass(frozen=True)
class Axis:
    """This process's place on the model axis: rank ``rank`` of the
    ``world`` ranks of ``group``."""

    group: Any
    rank: int
    world: int

    def split(self, n: int) -> "Split":
        """A tensor whose axis of ``n`` rows is split over this axis."""
        return Split(self.group, self.rank, self.world, n)


@dataclass(frozen=True)
class Split(Axis):
    """A tensor split along one axis over the ranks of ``group``: this rank
    holds rows ``partition(n, world, rank)`` of an axis ``n`` long.  The
    split axis is the first grid axis (axis 2 of a channels-first
    activation)."""

    n: int = 0

    def rows(self) -> Tuple[int, int]:
        return partition(self.n, self.world, self.rank)

    def rows_of(self, rank: int) -> Tuple[int, int]:
        return partition(self.n, self.world, rank)

    def at(self, n: int) -> "Split":
        """The same ranks, an axis ``n`` long."""
        return dataclasses.replace(self, n=n)


def _real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


def _wire(dtype: torch.dtype) -> torch.dtype:
    """The dtype a tensor crosses a collective in: bf16 travels as f32
    (gloo may not take bf16; a gather is exact either way)."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    out = t.to(_wire(t.dtype), copy=True).contiguous()
    dist.all_reduce(_real(out), group=group)
    return out.to(t.dtype)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group`` (a new tensor),
    differentiable: its backward sums the cotangents over the ranks."""
    return _AllReduceSum.apply(t, group)


def count_once(loss: torch.Tensor, rank: int) -> torch.Tensor:
    """The seed of the backward for a loss that every rank of an axis holds
    whole: the loss on the axis's rank 0, zero times it elsewhere (every
    rank still runs the backward, and so every collective in it)."""
    return loss if rank == 0 else loss * 0.0


def _pieces(band: Tuple[int, int], own: Tuple[int, int]):
    """A band of rows cut by a rank's own rows: (above, own part, below),
    each as [lo, hi) in global rows (possibly empty)."""
    (blo, bhi), (lo, hi) = band, own
    above = (blo, max(blo, min(bhi, lo)))
    mine = (max(blo, lo), max(max(blo, lo), min(bhi, hi)))
    below = (min(bhi, max(blo, hi)), bhi)
    return above, mine, below


def _fill(buf: torch.Tensor, buf_rows: List[Tuple[int, int]], src: torch.Tensor,
          src_rows: Tuple[int, int], add: bool = False) -> None:
    """Copy (or add) the rows that ``src`` (global rows ``src_rows`` on axis
    2) shares with each piece of ``buf`` (pieces of global rows
    ``buf_rows``, laid end to end on axis 2), in either direction: with
    ``add`` the buffer's rows are added into ``src``."""
    at = 0
    for lo, hi in buf_rows:
        a, b = max(lo, src_rows[0]), min(hi, src_rows[1])
        if a < b:
            bs = buf.narrow(2, at + a - lo, b - a)
            ss = src.narrow(2, a - src_rows[0], b - a)
            if add:
                ss.add_(bs)
            else:
                bs.copy_(ss)
        at += hi - lo


def _halo_rows(split: Split, bands, q: int):
    """The rows of rank ``q``'s band held by other ranks: its (above, below)
    pieces."""
    above, _, below = _pieces(bands[q], split.rows_of(q))
    return [above, below]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, bands):
        ctx.split, ctx.bands = split, bands
        own = split.rows()
        above, mine, below = _pieces(bands[split.rank], own)
        got = {}
        for q in range(split.world):
            halo = _halo_rows(split, bands, q)
            size = sum(hi - lo for lo, hi in halo)
            if size == 0:
                continue
            shape = list(x.shape)
            shape[2] = size
            buf = x.new_zeros(shape, dtype=_wire(x.dtype))
            if q != split.rank:
                _fill(buf, halo, x, own)
            dist.all_reduce(_real(buf), group=split.group)
            if q == split.rank:
                got = dict(zip(("above", "below"),
                               buf.to(x.dtype).split([h[1] - h[0] for h in halo], 2)))
        n_mine = mine[1] - mine[0]
        parts = [got.get("above"), x.narrow(2, mine[0] - own[0], n_mine) if n_mine else None,
                 got.get("below")]
        return torch.cat([p for p in parts if p is not None and p.shape[2]], dim=2)

    @staticmethod
    def backward(ctx, g):
        split, bands = ctx.split, ctx.bands
        own = split.rows()
        above, mine, below = _pieces(bands[split.rank], own)
        gx_shape = list(g.shape)
        gx_shape[2] = own[1] - own[0]
        gx = g.new_zeros(gx_shape)
        n_above, n_mine = above[1] - above[0], mine[1] - mine[0]
        if n_mine:
            gx.narrow(2, mine[0] - own[0], n_mine).add_(g.narrow(2, n_above, n_mine))
        for q in range(split.world):
            halo = _halo_rows(split, bands, q)
            size = sum(hi - lo for lo, hi in halo)
            if size == 0:
                continue
            if q == split.rank:
                n_below = below[1] - below[0]
                buf = torch.cat([g.narrow(2, 0, n_above),
                                 g.narrow(2, n_above + n_mine, n_below)], dim=2)
                buf = buf.to(_wire(g.dtype)).contiguous()
            else:
                shape = list(g.shape)
                shape[2] = size
                buf = g.new_empty(shape, dtype=_wire(g.dtype))
            dist.broadcast(_real(buf), src=dist.get_global_rank(split.group, q),
                           group=split.group)
            if q != split.rank:
                _fill(buf, halo, gx, own, add=True)
        return gx, None, None


def gather_rows(x: torch.Tensor, split: Split, bands: List[Tuple[int, int]]) -> torch.Tensor:
    """Rows ``bands[split.rank]`` (global, on axis 2) of a tensor of which
    each rank holds its ``split.rows()``: the rank's own rows and the ones
    its neighbours hold, differentiable.  ``bands`` lists every rank's band
    (every rank takes part in every rank's gather): for each band, one
    ``all_reduce`` of the rows the band needs from other ranks, and in the
    backward one ``broadcast`` of their cotangents from the band's rank."""
    return _GatherRows.apply(x, split, tuple(bands))


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        n = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * tp.world
        full = x.new_zeros(shape, dtype=_wire(x.dtype))
        full.narrow(dim, n * tp.rank, n).copy_(x)
        dist.all_reduce(_real(full), group=tp.group)
        return full.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        dim, tp = ctx.dim, ctx.tp
        n = g.shape[dim] // tp.world
        return _all_reduce(g, tp.group).narrow(dim, n * tp.rank, n), None, None


def gather_channels(x: torch.Tensor, dim: int, tp: Axis) -> torch.Tensor:
    """Every rank's equal channel shard of ``x`` (axis ``dim``), in rank
    order, on every rank: the channels that the next layer reads.  One
    ``all_reduce`` of a zero-filled buffer each way (the backward sums the
    cotangents and keeps this rank's shard)."""
    return _GatherChannels.apply(x, dim, tp)
