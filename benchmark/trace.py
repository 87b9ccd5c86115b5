"""A ``torch.profiler`` capture of a fixed number of steps or batches inside
the window, reduced to what the per-layer metrics read.

The profiler records the card's activity alone (kernels, copies, sets):
recording every host operation as well doubled a darcy_s211 training
step's host time, and so the idle share it read.  The traced window opens
and closes on a synchronisation, so every activity in the capture lies in
it, and its length is the host clock's between the two.  Spans the
benchmark times itself (``span``: the optimizer's step) are CUDA event
pairs on the stream, read after the window.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


@dataclass
class Trace:
    """Device activities (name, start s, end s) on the trace's clock."""

    device: List[Tuple[str, float, float]] = field(default_factory=list)
    window_s: float = 0.0
    steps: int = 0
    spans_ms: Dict[str, List[float]] = field(default_factory=dict)

    def busy_s(self) -> float:
        """Length of the union of the device's intervals."""
        total, end = 0.0, float("-inf")
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            a = max(a, end)
            if b > a:
                total += b - a
                end = b
        return total

    def kernel_s(self, patterns: Iterable[str]) -> Tuple[float, int]:
        """Device time and count of the activities whose lower-case name
        holds one of ``patterns``."""
        pats = [p.lower() for p in patterns]
        hits = [b - a for n, a, b in self.device if any(p in n.lower() for p in pats)]
        return sum(hits), len(hits)

    def top_ops(self, k: int = 10) -> List[List]:
        """The device activities that took most time, summed by name."""
        sums: Dict[str, float] = {}
        for n, a, b in self.device:
            sums[n] = sums.get(n, 0.0) + (b - a)
        return [[n[:160], t] for n, t in sorted(sums.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The longest gaps with nothing on the device, each named by the
        activity the card waited for: the one the host launched next."""
        gaps, end = [], None
        for n, a, b in sorted(self.device, key=lambda e: e[1]):
            if end is not None and a > end:
                gaps.append((a - end, n))
            end = b if end is None else max(end, b)
        gaps.sort(key=lambda g: -g[0])
        return [[f"before {n[:150]}", t] for t, n in gaps[:k]]


def parse(path: str) -> List[Tuple[str, float, float]]:
    """The device activities of a Chrome trace written by ``torch.profiler``
    (times in microseconds)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            a = float(e["ts"]) * 1e-6
            out.append((e.get("name", ""), a, a + float(e.get("dur", 0.0)) * 1e-6))
    return out


class Capture:
    """The traced steps: ``start()`` after the run has synchronised,
    ``stop()`` after it has synchronised again; ``trace()`` reads it
    afterwards, outside the window.  On the CPU (the harness's tests) there
    is no device activity to record, and only the clock and spans run."""

    def __init__(self, device):
        import torch

        self.device = device
        self.prof = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
                     if device.type == "cuda" else None)
        self.steps = 0
        self.events: Dict[str, list] = {}
        self.t = [0.0, 0.0]

    def start(self) -> None:
        if self.prof is not None:
            self.prof.start()
        self.t[0] = time.perf_counter()

    def stop(self) -> None:
        self.t[1] = time.perf_counter()
        if self.prof is not None:
            self.prof.stop()

    @contextlib.contextmanager
    def span(self, name: str):
        """Time the block on the stream (CUDA events), or on the host clock
        on the CPU."""
        import torch

        if self.device.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            yield
            b.record()
            self.events.setdefault(name, []).append((a, b))
        else:
            t = time.perf_counter()
            yield
            self.events.setdefault(name, []).append((t, time.perf_counter()))

    def trace(self) -> Trace:
        spans = {n: [a.elapsed_time(b) if hasattr(a, "elapsed_time") else (b - a) * 1e3
                     for a, b in pairs] for n, pairs in self.events.items()}
        tr = Trace(window_s=self.t[1] - self.t[0], steps=self.steps, spans_ms=spans)
        if self.prof is not None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self.prof.export_chrome_trace(path)
                tr.device = parse(path)
            finally:
                os.remove(path)
        return tr


def span(cap, name: str, on: bool):
    """``cap.span(name)`` while tracing, else nothing."""
    return cap.span(name) if on and cap is not None else contextlib.nullcontext()
