"""Partial DFT transforms as single matmuls (port of ``uno_tpu/ops/dft.py``).

A U-NO spectral conv keeps only ``m`` low-frequency modes of an ``S``-point
transform, so each transform is a *partial DFT*: a small dense table applied
along one axis, one ``torch.einsum`` per stage.  Complex arrays are carried
as real tensors with a **(re, im) plane axis at position 2** (after batch
and channel); the complex stages contract or produce that axis in the same
einsum as the spatial axis, through 2x2 block tables.

Conventions match ``numpy.fft`` with ``norm="forward"`` (scale 1/n on the
forward transform, none on the inverse), and the c2r inverse reproduces
``irfft``: the imaginary parts of the DC and Nyquist bins are dropped and
interior bins are doubled.

dtype rule (``uno_tpu``'s ``_dot``): a bf16 input runs with bf16 operands,
f32 accumulation and a bf16 output; a float64 input (the tests' gradcheck)
runs in float64; anything else runs in f32.  On a card
the f32 products are full f32 only with TF32 off, and the bf16 products
accumulate in f32 only with
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`` off:
the entry points (``uno_tpu_torch.cli``, ``chip_smoke.py``) set both.
``uno_tpu``'s ``set_precision`` (multi-pass bf16 on the TPU) is not ported.

The tables are numpy, made and cached by copies of ``uno_tpu``'s table
functions below (``tests/test_torch_guards.py`` holds them equal), and each
is moved to a device once per (table, dtype, device).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

# The (re, im) plane axis of packed complex tensors.  Spectral-conv data is
# (B, C, *spatial), so the plane axis slots in after channels and negative
# spatial-axis indices keep meaning the same spatial axis.
PLANE_AXIS = 2
_L = "abcdefgh"


def _cs(n: int, idx, n_out_div: float) -> tuple[np.ndarray, np.ndarray]:
    """cos/sin tables (len(idx), n) of angle 2*pi*k*j/n, divided by n_out_div."""
    k = np.asarray(idx, np.float64)[:, None]
    j = np.arange(n, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * j / n
    return (
        (np.cos(ang) / n_out_div).astype(np.float32),
        (np.sin(ang) / n_out_div).astype(np.float32),
    )


@lru_cache(maxsize=256)  # bounded: resolution sweeps otherwise accumulate host tables (ADVICE r2)
def _fwd_real_T(n: int, idx: tuple, scaled: bool) -> np.ndarray:
    """(n, 2, K) block: X[k] = sum_j x[j] e^{-2 pi i k j / n} (/n if scaled).

    Plane 0 rows are cos (re), plane 1 rows are -sin (im).
    """
    c, s = _cs(n, idx, float(n) if scaled else 1.0)
    return np.stack([c.T, -s.T], axis=1)  # (n, 2, K)


@lru_cache(maxsize=256)  # bounded: resolution sweeps otherwise accumulate host tables (ADVICE r2)
def _fwd_cplx_T(n: int, idx: tuple, scaled: bool) -> np.ndarray:
    """(2, n, 2, K) block for a forward DFT of packed-complex input.

    (xr + i xi)(cos - i sin): re = xr@c + xi@s, im = xi@c - xr@s.
    Layout T[p_in, j, p_out, k].
    """
    c, s = _cs(n, idx, float(n) if scaled else 1.0)
    ct, st = c.T, s.T  # (n, K)
    return np.stack(
        [np.stack([ct, -st], axis=1), np.stack([st, ct], axis=1)], axis=0
    )


@lru_cache(maxsize=256)  # bounded: resolution sweeps otherwise accumulate host tables (ADVICE r2)
def _inv_cplx_T(n: int, idx: tuple, scaled: bool) -> np.ndarray:
    """(2, K, 2, n) block for a full inverse DFT from bins ``idx`` (others
    zero): x[p] = sum_k X[k] e^{+2 pi i k p / n} (/n if scaled).

    (yr + i yi)(cos + i sin): re = yr@c - yi@s, im = yr@s + yi@c.
    Layout T[p_in, k, p_out, pos].
    """
    c, s = _cs(n, idx, float(n) if scaled else 1.0)  # (K, n)
    return np.stack(
        [np.stack([c, s], axis=1), np.stack([-s, c], axis=1)], axis=0
    )


@lru_cache(maxsize=256)  # bounded: resolution sweeps otherwise accumulate host tables (ADVICE r2)
def _inv_real_T(m: int, n_out: int, scaled: bool) -> np.ndarray:
    """(2, m, n_out) block reproducing ``irfft(..., n=n_out)`` from the ``m``
    leading half-spectrum bins: interior bins doubled, DC/Nyquist counted
    once with imaginary part dropped."""
    c, s = _cs(n_out, tuple(range(m)), float(n_out) if scaled else 1.0)
    w = np.full((m, 1), 2.0, np.float32)
    w[0, 0] = 1.0
    if n_out % 2 == 0 and m - 1 == n_out // 2:
        w[-1, 0] = 1.0
    return np.stack([w * c, -(w * s)], axis=0)  # (2, m, n_out)


def _build_device_table(table_fn, args: tuple, dtype: torch.dtype,
                        device: torch.device) -> torch.Tensor:
    """``table_fn(*args)`` as a tensor of ``dtype`` on ``device``.

    Built outside inference mode even when first asked for inside it: a
    cached inference tensor could not be used by a later backward in the
    same process (serving, then training)."""
    with torch.inference_mode(False):
        return torch.from_numpy(table_fn(*args)).to(device=device, dtype=dtype)


# moved once per process; while torch.export traces, tensors are fake, and a
# table built then is not cached (the trace records it as a constant)
_cached_device_table = lru_cache(maxsize=256)(_build_device_table)


def _device_table(table_fn, args: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    build = _build_device_table if torch.compiler.is_exporting() else _cached_device_table
    return build(table_fn, args, dtype, device)


@lru_cache(maxsize=256)
def _rows_T(table_fn, args: tuple, axis: int, lo: int, hi: int) -> np.ndarray:
    """Rows ``[lo, hi)`` of ``table_fn(*args)``'s spatial axis ``axis``: the
    table of a transform of the rows one rank holds (``parallel/spatial.py``)."""
    return np.ascontiguousarray(np.take(table_fn(*args), np.arange(lo, hi), axis=axis))


def _table(table_fn, args: tuple, axis: int, rows) -> tuple:
    """(table function, args) of a whole table, or of its ``rows``."""
    return (table_fn, args) if rows is None else (_rows_T, (table_fn, args, axis, *rows))


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype rule above: bf16 and float64 stay, anything else is f32."""
    return dtype if dtype in (torch.bfloat16, torch.float64) else torch.float32


def _dot(x: torch.Tensor, table_fn, args: tuple, ein: str) -> torch.Tensor:
    """One stage: ``einsum(ein, x, table)`` under the dtype rule."""
    dt = compute_dtype(x.dtype)
    return torch.einsum(ein, x.to(dt), _device_table(table_fn, args, dt, x.device))


def fwd_real(x: torch.Tensor, axis: int, n: int, idx: Sequence[int],
             scaled: bool = True) -> torch.Tensor:
    """Forward partial DFT of a real tensor along ``axis`` at bins ``idx``.

    x has NO plane axis; the result gains the (re, im) plane axis at
    position 2 and the transformed axis becomes length ``len(idx)``.
    """
    ax = axis % x.ndim
    lhs = _L[: x.ndim]
    out = lhs[:2] + "v" + lhs[2:ax] + "z" + lhs[ax + 1 :]
    return _dot(x, _fwd_real_T, (n, tuple(idx), scaled), f"{lhs},{lhs[ax]}vz->{out}")


def _cplx_ein(ndim: int, ax: int) -> str:
    letters = list(_L[:ndim])
    letters[PLANE_AXIS] = "u"
    a = letters[ax]
    out = list(letters)
    out[PLANE_AXIS] = "v"
    out[ax] = "z"
    return f"{''.join(letters)},u{a}vz->{''.join(out)}"


def fwd_cplx(x: torch.Tensor, axis: int, n: int, idx: Sequence[int],
             scaled: bool = True, rows=None) -> torch.Tensor:
    """Forward partial DFT along ``axis`` of a packed-complex tensor (plane
    axis at position 2), contracting (plane, axis) in one einsum.  With
    ``rows`` (lo, hi), x holds only those rows of the ``n``-long axis and
    the result is their part of the sum."""
    ax = axis % x.ndim
    return _dot(x, *_table(_fwd_cplx_T, (n, tuple(idx), scaled), 1, rows),
                _cplx_ein(x.ndim, ax))


def inv_cplx(x: torch.Tensor, axis: int, n: int, idx: Sequence[int],
             scaled: bool = False, rows=None) -> torch.Tensor:
    """Full inverse DFT along ``axis`` from bins ``idx`` (all others zero) of
    a packed-complex tensor; the output axis has length ``n``, or holds only
    its ``rows`` (lo, hi).  ``scaled`` divides by n (the default/backward
    norm)."""
    ax = axis % x.ndim
    return _dot(x, *_table(_inv_cplx_T, (n, tuple(idx), scaled), 3, rows),
                _cplx_ein(x.ndim, ax))


def inv_real(x: torch.Tensor, axis: int, n_out: int, scaled: bool = False) -> torch.Tensor:
    """Real inverse from the leading half-spectrum bins along ``axis`` of a
    packed-complex tensor (zero padding to n_out//2+1 implicit), matching
    ``irfft(..., n=n_out)`` with norm="forward" (default) or the backward
    norm (``scaled``).  Consumes the plane axis."""
    ax = axis % x.ndim
    m = x.shape[ax]
    letters = list(_L[: x.ndim])
    letters[PLANE_AXIS] = "u"
    a = letters[ax]
    out = [("z" if i == ax else l) for i, l in enumerate(letters) if i != PLANE_AXIS]
    return _dot(x, _inv_real_T, (m, n_out, scaled), f"{''.join(letters)},u{a}z->{''.join(out)}")


# --- VJP transposes ---------------------------------------------------------
# Each forward transform is one einsum against a constant table, so its
# vector-Jacobian transpose is again one einsum against the SAME table with
# the contraction flipped.  The DFT-path spectral conv's backward
# (ops/spectral.py) is the chain of these.


def t_fwd_real(g: torch.Tensor, axis: int, n: int, idx: Sequence[int],
               scaled: bool = True) -> torch.Tensor:
    """Transpose of ``fwd_real``: packed cotangent (plane axis at 2, bins at
    ``axis``) -> real cotangent with the transformed axis restored to
    length ``n``."""
    ax = axis % g.ndim
    letters = list(_L[: g.ndim])
    letters[PLANE_AXIS] = "u"
    letters[ax] = "z"
    out = [("j" if i == ax else l) for i, l in enumerate(letters) if i != PLANE_AXIS]
    return _dot(g, _fwd_real_T, (n, tuple(idx), scaled), f"{''.join(letters)},juz->{''.join(out)}")


def t_fwd_cplx(g: torch.Tensor, axis: int, n: int, idx: Sequence[int],
               scaled: bool = True) -> torch.Tensor:
    """Transpose of ``fwd_cplx`` along ``axis``."""
    ax = axis % g.ndim
    letters = list(_L[: g.ndim])
    letters[PLANE_AXIS] = "v"
    letters[ax] = "z"
    out = list(letters)
    out[PLANE_AXIS] = "u"
    out[ax] = "j"
    return _dot(g, _fwd_cplx_T, (n, tuple(idx), scaled), f"{''.join(letters)},ujvz->{''.join(out)}")


def t_inv_cplx(g: torch.Tensor, axis: int, n: int, idx: Sequence[int],
               scaled: bool = False) -> torch.Tensor:
    """Transpose of ``inv_cplx``: cotangent with full axis ``n`` ->
    cotangent at the ``len(idx)`` kept bins."""
    ax = axis % g.ndim
    letters = list(_L[: g.ndim])
    letters[PLANE_AXIS] = "v"
    letters[ax] = "z"
    out = list(letters)
    out[PLANE_AXIS] = "u"
    out[ax] = "k"
    return _dot(g, _inv_cplx_T, (n, tuple(idx), scaled), f"{''.join(letters)},ukvz->{''.join(out)}")


def t_inv_real(g: torch.Tensor, axis: int, m: int, n_out: int,
               scaled: bool = False) -> torch.Tensor:
    """Transpose of ``inv_real``: real cotangent (axis length ``n_out``) ->
    packed cotangent at the ``m`` leading half-spectrum bins (plane axis
    gained at position 2)."""
    ax = axis % g.ndim
    letters = list(_L[: g.ndim])
    letters[ax] = "z"
    out = list(letters)
    out[ax] = "k"
    out = out[:PLANE_AXIS] + ["u"] + out[PLANE_AXIS:]
    return _dot(g, _inv_real_T, (m, n_out, scaled), f"{''.join(letters)},ukz->{''.join(out)}")


def pack(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """Stack (re, im) planes into the packed layout (plane axis at 2)."""
    return torch.stack([re, im], dim=PLANE_AXIS)


def unpack(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split a packed-complex tensor into its (re, im) planes."""
    return x.select(PLANE_AXIS, 0), x.select(PLANE_AXIS, 1)
