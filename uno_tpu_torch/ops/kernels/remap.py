"""One remap of a complex spectrum through separable per-axis index maps:
``remap_kernel`` (``uno_tpu_torch/csrc/spectrum.cu``) on the card, and
``remap_plain`` (indexing, sums and a mirror) for the CPU and for
float64 / complex128 (``gradcheck``).

Replaces no TPU kernel: ``uno_tpu`` slices and pads its spectra with jnp
ops that XLA fuses.  The FFT path of ``ops/spectral.py`` (every rank; a 1-D
or 2-D spectrum with leading axes of length 1) lays out each
spectrum around cuFFT and the contraction with one remap in each
direction; the source says what a remap computes and how the kernel is
built.

A remap is a ``Plan``: the destination's last three dimensions ``(D1, D2,
D3)``, the table of ints ``rows`` (D1 x 2), ``cols`` (D2 x 2), ``bins``
(D3) and ``herm`` (D3), laid end to end, and ``scale`` (D3 floats).  The
source is (B, C, S1, S2, S3), the destination (B, C, D1, D2, D3), fresh:
every element is written, zeros included.  ``plan`` builds one from lists
of source indices a destination index (``Plan``'s docstring).

The forward is also the custom op ``uno_tpu_torch::remap``
(``torch.library``), so that ``torch.export`` records it as one node whose
table is part of the node's arguments; only tracing goes through it
(``torch.compiler.is_exporting()``), as for ``uno_tpu_torch::contract``.
The kernel's tables and the plain version's index tensors are made once
per plan and device, at the first remap that runs there (never while
``torch.export`` traces: the op's fake version reads none).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Sequence, Tuple

import torch

from uno_tpu_torch.ops.kernels._build import check, device_limits, library

# kernel launches since the count was last set to 0
LAUNCHES = {"remap": 0}
THREADS = 256     # threads a block (csrc/spectrum.cu takes any multiple of 32 to 1024)
GRID_MAX = 65535  # csrc/spectrum.cu: GRID_MAX, the most channel slices a launch takes
FILL = 4 * 2048   # threads an SM that a launch aims at: four waves of a full SM


class Plan:
    """A remap: ``dst[i, j, k] = scale[k] * (herm[k] ? (T(i, j, k) +
    conj(T(-i, -j, k))) / 2 : T(i, j, k))``, ``T(i, j, k) = sum_q sum_p
    src[rows[i][p], cols[j][q], bins[k]]`` over the entries that are not -1
    (none: 0), ``-i`` and ``-j`` modulo D1 and D2.  Made by ``plan``, one
    object for each value; holds its tensors per device."""

    __slots__ = ("shape", "tab", "scale", "_tables", "_plain")

    def __init__(self, shape: Tuple[int, int, int], tab: Tuple[int, ...],
                 scale: Tuple[float, ...]):
        self.shape, self.tab, self.scale = shape, tab, scale
        self._tables, self._plain = {}, {}

    def tables(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The kernel's int32 table and f32 scales on ``device``, made at the
        first call there (outside inference mode: a later backward may read
        them)."""
        device = torch.device(device)
        if device not in self._tables:
            with torch.inference_mode(False):
                self._tables[device] = (
                    torch.tensor(self.tab, dtype=torch.int32).to(device),
                    torch.tensor(self.scale, dtype=torch.float32).to(device))
        return self._tables[device]

    def steps(self, device, dtype) -> tuple:
        """``remap_plain``'s ops for a spectrum on ``device`` whose real dtype
        is ``dtype``, made at the first call there: each axis's gathers
        (``_gathers``), the Hermitian bins and the first two axes' mirror
        (None: no bin), and the scales in ``dtype`` (None: all 1, a product
        that is exact and skipped)."""
        key = (torch.device(device), dtype)
        if key not in self._plain:
            (d1, d2, d3), t = self.shape, self.tab
            rows, cols = t[: 2 * d1], t[2 * d1 : 2 * d1 + 2 * d2]
            bins, herm = t[2 * d1 + 2 * d2 : 2 * d1 + 2 * d2 + d3], t[2 * d1 + 2 * d2 + d3 :]
            keep = [k for k in range(d3) if herm[k]]
            dev = key[0]
            with torch.inference_mode(False):
                axes = (_gathers(rows, dev), _gathers(cols, dev),
                        _gathers(tuple(v for b in bins for v in (b, -1)), dev))
                mirror = None
                if keep:
                    mirror = (_longs(keep, dev),
                              _longs([-i % d1 for i in range(d1)], dev) if d1 > 1 else None,
                              _longs([-j % d2 for j in range(d2)], dev))
                scale = (None if all(v == 1 for v in self.scale)
                         else torch.tensor(self.scale, dtype=dtype, device=dev))
            self._plain[key] = (axes, mirror, scale)
        return self._plain[key]


@lru_cache(maxsize=1024)
def _interned(shape: tuple, tab: tuple, scale: tuple) -> Plan:
    return Plan(shape, tab, scale)


def _pair(srcs: Sequence[int]) -> Tuple[int, int]:
    if len(srcs) > 2:
        raise ValueError(f"a remap takes at most two sources an index, got {tuple(srcs)}")
    return tuple(srcs) + (-1,) * (2 - len(srcs))


def plan(rows: Sequence[Sequence[int]], cols: Sequence[Sequence[int]],
         bins: Sequence[Optional[int]], scale: Optional[Sequence[float]] = None,
         herm: Sequence[int] = ()) -> Plan:
    """The ``Plan`` whose destination index ``i`` of the first axis sums the
    source rows ``rows[i]`` (zero to two), ``j`` the columns ``cols[j]``,
    bin ``k`` reads source bin ``bins[k]`` (None: the bin is 0) times
    ``scale[k]`` (default 1), and the bins ``herm`` take their Hermitian
    part along the first two axes."""
    d3 = len(bins)
    scale = (1.0,) * d3 if scale is None else tuple(float(s) for s in scale)
    if len(scale) != d3 or any(not 0 <= k < d3 for k in herm):
        raise ValueError(f"a remap of {d3} bins takes {d3} scales and herm bins in [0, {d3})")
    tab = (tuple(v for r in rows for v in _pair(r)) + tuple(v for c in cols for v in _pair(c))
           + tuple(-1 if b is None else b for b in bins)
           + tuple(int(k in herm) for k in range(d3)))
    return _interned((len(rows), len(cols), d3), tab, scale)


def _longs(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.long, device=device)


def _gathers(pairs: Tuple[int, ...], device) -> tuple:
    """One axis's map (two source indices an index, -1 for none, laid end
    to end) as ``_gather``'s source columns, the first always and the
    second where it has an entry: each its index tensor and whether it
    has a -1."""
    cols = [pairs[0::2]] + [c for c in [pairs[1::2]] if max(c) >= 0]
    return tuple((_longs(c, device), min(c) < 0) for c in cols)


def _gather(x: torch.Tensor, dim: int, cols: tuple) -> torch.Tensor:
    """Along ``dim``, the sum over ``cols`` (``_gathers``) of x at their
    indices, 0 where an index is -1: indexing (not ``index_select``, ≈ 4x
    slower along the last axis on the CPU), a -1 reading a slice of zeros
    put after x's last."""
    padded = out = None
    for idx, absent in cols:
        if absent and padded is None:
            shape = list(x.shape)
            shape[dim] = 1
            padded = torch.cat([x, x.new_zeros(shape)], dim)
        sel = (padded if absent else x)[(slice(None),) * dim + (idx,)]
        out = sel if out is None else out + sel
    return out


def remap_plain(src: torch.Tensor, p: Plan) -> torch.Tensor:
    """The remap as torch ops: the kernel's reference, in its order of
    operations (the sum over rows, then over columns, the Hermitian half,
    the scale)."""
    axes, mirror, scale = p.steps(src.device, src.real.dtype)
    t = src
    for dim, cols in zip((2, 3, 4), axes):
        t = _gather(t, dim, cols)
    if mirror is not None:
        keep, mi, mj = mirror
        sl = t.index_select(4, keep)
        mir = (sl if mi is None else sl.index_select(2, mi)).index_select(3, mj)
        t.index_copy_(4, keep, torch.view_as_complex(torch.view_as_real(sl + mir.conj()) * 0.5))
    if scale is None:
        return t
    return torch.view_as_complex(torch.view_as_real(t) * scale[:, None])


def _validate(src: torch.Tensor, shape) -> None:
    if src.dtype not in (torch.complex64, torch.complex128) or src.ndim != 5:
        raise TypeError(f"remap takes a 5-D complex spectrum, got {src.dtype} "
                        f"{tuple(src.shape)}")
    if src.device.type == "cuda":
        if src.dtype != torch.complex64:
            raise TypeError(f"remap: the CUDA kernel takes complex64, got {src.dtype}")
        if src.shape[0] * src.shape[1] >= 2**31 or math.prod(shape) >= 2**31:
            raise ValueError(f"remap: {tuple(src.shape)} -> {tuple(shape)} is past the "
                             f"kernel's grid")
    elif src.device.type != "cpu":
        raise ValueError(f"remap runs on cpu or cuda, not {src.device}")


def slices(bc: int, plane: int, sms: int) -> int:
    """Blocks along the grid's y for ``bc`` channels of a ``plane``-element
    destination: enough that the launch holds about ``FILL`` threads an SM,
    each walking the channels of its (i, j, k) ``slices`` apart."""
    return max(1, min(bc, GRID_MAX, -(-sms * FILL // plane)))


def _remap(src: torch.Tensor, p: Plan) -> torch.Tensor:
    _validate(src, p.shape)
    if src.device.type == "cpu":
        return remap_plain(src, p)
    tab, scale = p.tables(src.device)
    src = src.contiguous()
    b, c, s1, s2, s3 = src.shape
    d1, d2, d3 = p.shape
    out = torch.empty((b, c, d1, d2, d3), dtype=src.dtype, device=src.device)
    ys = slices(b * c, d1 * d2 * d3, device_limits(src.device.index)[0])
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().uno_remap(src.data_ptr(), out.data_ptr(), tab.data_ptr(),
                                  scale.data_ptr(), b * c, s1, s2, s3, d1, d2, d3, THREADS, ys,
                                  stream)
    check(err, "uno_remap")
    LAUNCHES["remap"] += 1
    return out


@torch.library.custom_op("uno_tpu_torch::remap", mutates_args=())
def remap_op(src: torch.Tensor, tab: Sequence[int], scale: Sequence[float],
             shape: Sequence[int]) -> torch.Tensor:
    """The remap as a custom op: the kernel for a CUDA tensor, the plain
    version for a CPU one."""
    return _remap(src, _interned(tuple(shape), tuple(tab), tuple(scale)))


@remap_op.register_fake
def _remap_fake(src, tab, scale, shape):
    _validate(src, shape)
    return src.new_empty((*src.shape[:2], *shape))


def remap(src: torch.Tensor, p: Plan) -> torch.Tensor:
    """``src`` (B, C, S1, S2, S3) complex -> (B, C, *p.shape): not
    differentiable (the FFT path writes its backward by hand)."""
    if torch.compiler.is_exporting():
        return remap_op(src, list(p.tab), list(p.scale), list(p.shape))
    return _remap(src, p)
