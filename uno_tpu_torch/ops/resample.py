"""torch-parity separable resampling as precomputed matmuls.

Port of ``uno_tpu/ops/resample.py``.  ``resize_matrix`` is a verbatim copy of
the numpy table code (tests/test_torch_guards.py holds it bit-equal to the
original); ``resize`` applies one (out, in) table per resized axis as a
batched matmul along that axis, the way the JAX package applies its einsum.

The weight formulas replicate ``F.interpolate``:

* antialias path (both up- and down-sampling):
  ``scale = (in-1)/(out-1)`` if align_corners else ``in/out``;
  ``support = k/2 * max(scale, 1)``; ``center = scale*(i+0.5)``;
  window ``[int(center-support+0.5), int(center+support+0.5)) ∩ [0, in)``;
  ``w = filter((j - center + 0.5)/max(scale,1))`` normalised to sum 1.
  Filters: triangle (linear/bilinear/trilinear), cubic with A=-0.5
  (bicubic — note the aa path uses the PIL coefficient, not -0.75).
* non-antialias path: ``src = scale*i`` (align_corners) or
  ``scale*(i+0.5)-0.5`` (clamped to >=0 for linear, unclamped for cubic);
  2-tap triangle or 4-tap cubic with A=-0.75, indices edge-clamped.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence

import numpy as np
import torch

from uno_tpu_torch.parallel.spatial import Split, gather_rows, partition

_FILTER_SUPPORT = {"linear": 2, "cubic": 4, "nearest": 1}


def _triangle(t: np.ndarray) -> np.ndarray:
    return np.clip(1.0 - np.abs(t), 0.0, None)


def _cubic(t: np.ndarray, a: float) -> np.ndarray:
    t = np.abs(t)
    return np.where(
        t <= 1.0,
        ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0,
        np.where(t < 2.0, (((t - 5.0) * t + 8.0) * t - 4.0) * a, 0.0),
    )


@lru_cache(maxsize=256)  # bounded: resolution sweeps otherwise accumulate host tables
def resize_matrix(
    n_in: int,
    n_out: int,
    kernel: str = "linear",
    align_corners: bool = True,
    antialias: bool = True,
) -> np.ndarray:
    """(n_out, n_in) float32 resampling matrix replicating torch interpolate."""
    if kernel == "nearest":
        scale = n_in / n_out
        idx = np.minimum((np.arange(n_out) * scale).astype(np.int64), n_in - 1)
        m = np.zeros((n_out, n_in), np.float64)
        m[np.arange(n_out), idx] = 1.0
        return m.astype(np.float32)

    if n_out > 1:
        scale = (n_in - 1) / (n_out - 1) if align_corners else n_in / n_out
    else:
        scale = 0.0 if align_corners else float(n_in)

    m = np.zeros((n_out, n_in), np.float64)
    if antialias:
        support_taps = _FILTER_SUPPORT[kernel]
        eff = max(scale, 1.0)
        support = support_taps * 0.5 * eff
        invscale = 1.0 / eff
        filt = _triangle if kernel == "linear" else (lambda t: _cubic(t, -0.5))
        for i in range(n_out):
            center = scale * (i + 0.5)
            xmin = max(int(center - support + 0.5), 0)
            xmax = min(int(center + support + 0.5), n_in)
            idx = np.arange(xmin, xmax)
            w = filt((idx - center + 0.5) * invscale)
            total = w.sum()
            if total > 0:
                w = w / total
            m[i, idx] = w
    else:
        for i in range(n_out):
            if align_corners:
                src = scale * i
            else:
                src = scale * (i + 0.5) - 0.5
                if kernel == "linear" and src < 0.0:
                    src = 0.0
            i0 = int(np.floor(src))
            f = src - i0
            if kernel == "linear":
                taps = np.array([i0, i0 + 1])
                w = np.array([1.0 - f, f])
            else:  # cubic, A=-0.75, 4 taps
                taps = np.arange(i0 - 1, i0 + 3)
                w = _cubic(taps - src, -0.75)
            taps = np.clip(taps, 0, n_in - 1)
            for j, wj in zip(taps, w):
                m[i, j] += wj
    return m.astype(np.float32)


def _build_table(n_in, n_out, kernel, align_corners, antialias, device, dtype):
    """``resize_matrix`` as a tensor on ``device``.

    Built outside inference mode even when first asked for inside it: a
    cached inference tensor could not be saved for a later backward in the
    same process (serving, then training)."""
    wm = resize_matrix(n_in, n_out, kernel, align_corners, antialias)
    with torch.inference_mode(False):
        return torch.from_numpy(wm).to(device=device, dtype=dtype)


# built once per process; while torch.export traces, tensors are fake, and
# a table built then is not cached (the trace records it as a constant)
_table = lru_cache(maxsize=256)(_build_table)


@lru_cache(maxsize=256)
def _bands(n_in, n_out, kernel, align_corners, antialias, world) -> tuple:
    """Per rank of a split axis, the input rows [lo, hi) that its output
    rows read: the nonzero columns of its rows of the (out, in) table."""
    wm = resize_matrix(n_in, n_out, kernel, align_corners, antialias)
    bands = []
    for q in range(world):
        lo, hi = partition(n_out, world, q)
        cols = np.flatnonzero(np.any(wm[lo:hi] != 0, axis=0))
        bands.append((int(cols[0]), int(cols[-1]) + 1))
    return tuple(bands)


def resize(
    x: torch.Tensor,
    out_sizes: Sequence[int],
    axes: Sequence[int],
    kernel: str = "linear",
    align_corners: bool = True,
    antialias: bool = True,
    split: Optional[Split] = None,
) -> torch.Tensor:
    """Resize ``x`` along ``axes`` to ``out_sizes`` (torch interpolate parity).

    Each axis is resampled by a dense (out, in) matrix product; axes whose
    size is unchanged are skipped (scale 1 makes every kernel's table the
    identity).  Under bf16 the table is cast to bf16 so the product stays
    bf16 with f32 accumulation, as ``uno_tpu``'s mixed-precision policy has
    it; float64 resamples in float64 and any other dtype in f32.

    With ``split``, axis 2 is split over its ranks (``split.n`` rows): a
    rank's output rows read a band of input rows a few rows wider than its
    own (the tables are banded), which ``gather_rows`` brings from its
    neighbours; the rank never holds the whole axis.
    """
    assert len(out_sizes) == len(axes)
    dtype = x.dtype
    cdt = dtype if dtype in (torch.bfloat16, torch.float64) else torch.float32
    for ax, out_size in zip(axes, out_sizes):
        ax = ax % x.ndim
        split_ax = split is not None and ax == 2
        n_in = split.n if split_ax else x.shape[ax]
        if n_in == out_size:
            continue
        table = _build_table if torch.compiler.is_exporting() else _table
        wm = table(n_in, out_size, kernel, align_corners, antialias, x.device, cdt)
        if split_ax:
            bands = _bands(n_in, out_size, kernel, align_corners, antialias, split.world)
            (lo, hi), (blo, bhi) = split.at(out_size).rows(), bands[split.rank]
            xb = gather_rows(x.to(cdt), split, bands)
            x = torch.matmul(wm[lo:hi, blo:bhi], xb.movedim(2, -2)).movedim(-2, 2)
            continue
        xc = x.to(cdt)
        if ax == x.ndim - 1:
            x = torch.matmul(xc, wm.t())
        else:
            # (out, in) @ x with the resized axis at dim -2: a batched
            # matmul that leaves the other axes in place
            x = torch.matmul(wm, xc.movedim(ax, -2)).movedim(-2, ax)
    return x.to(dtype)
