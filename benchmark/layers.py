"""The arithmetic the per-layer metrics' readers share (``metrics/``).

A reader gets the run's reading ``r``: ``trace`` (rank 0's ``trace.Trace``
over ``trace.steps`` steps or batches), ``busy_s`` (the device's busy time
in the traced window, averaged over the ranks), ``cfg``, ``batch`` (the
global batch), ``chips``, ``kind`` (``train`` or ``serve``) and ``peak``
(``counts.PEAKS``' row for the card).  A reader that finds nothing to read
returns None, and the metric is left out of the run's line.
"""

from __future__ import annotations

from typing import Iterable, Optional

from benchmark import counts


def idle_share(r) -> Optional[float]:
    """The traced window's share, in %, with nothing on the device."""
    if r.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.trace.window_s)


def mfu(r) -> Optional[float]:
    """The configuration's flops over the traced window's wall time, in % of
    the chips' bf16 peak."""
    if r.busy_s <= 0:
        return None
    flops = counts.step_flops(r.cfg, r.batch, r.kind) * r.trace.steps
    return 100.0 * flops / (r.trace.window_s * r.chips * r.peak["bf16_flops"])


def device_ms(r, patterns: Iterable[str]) -> Optional[float]:
    """Device ms a step of the activities whose names hold a pattern."""
    t, n = r.trace.kernel_s(patterns)
    return 1e3 * t / r.trace.steps if n else None


def span_ms(r, name: str) -> Optional[float]:
    """The mean ms of the benchmark's span ``name`` (CUDA events on the
    stream around the call) over the traced steps."""
    ms = r.trace.spans_ms.get(name)
    return sum(ms) / len(ms) if ms and r.busy_s > 0 else None


def activities(r) -> Optional[float]:
    """Kernels, copies and sets on the device a step."""
    n = len(r.trace.device)
    return n / r.trace.steps if n else None


def roofline(r, key: str, patterns: Iterable[str]) -> Optional[float]:
    """The bound of the work ``counts.bounds`` counts under ``key`` over the
    device time of the kernels named by ``patterns``, in %."""
    t, n = r.trace.kernel_s(patterns)
    if not n:
        return None
    per_rank = r.batch // r.chips
    bound = counts.bounds(r.cfg, per_rank, r.kind, r.peak)[key] * r.trace.steps
    return 100.0 * bound / t
