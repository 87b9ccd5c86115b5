"""The program's spans (``uno_tpu_torch/utils/profiling.py`` ``annotate``)
read on the device trace's clock.

``SpanCapture`` is ``trace.Capture`` with the program's recording on inside
the profiler's window; its ``trace()`` is a ``SpanTrace``: the main
thread's spans and the window's two ends, on the clock of the device's
activities (seconds past the Chrome trace's ``baseTimeNanoseconds``, which
with ``ts`` is the Unix epoch's clock; the recording's anchor puts the
host's ``perf_counter`` there).  ``host_ms`` and ``idle_split`` are the
arithmetic of the span metrics' readers (``metrics/*_host_ms.*.py``,
``metrics/idle_*_ms.*.py``).

``traffic/train_step.py`` and ``traffic/serve_batch.py`` make the plain
``trace.Capture``, so under ``benchmark.run`` these readers find nothing
and return None.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from benchmark import trace

Interval = Tuple[float, float]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Sorted disjoint intervals covering the same points."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(window: Interval, covered: List[Interval]) -> List[Interval]:
    """The parts of ``window`` that the sorted disjoint ``covered`` leaves."""
    out, at = [], window[0]
    for a, b in covered:
        if a > at:
            out.append((at, min(a, window[1])))
        at = max(at, b)
        if at >= window[1]:
            break
    if at < window[1]:
        out.append((at, window[1]))
    return [(a, b) for a, b in out if b > a]


def overlap(xs: List[Interval], ys: List[Interval]) -> float:
    """Length of the points in both (each sorted and disjoint)."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


@dataclass
class SpanTrace(trace.Trace):
    """A ``trace.Trace`` with the main thread's spans (name, start s, end s,
    whether it is at the top of the thread) and the window's two ends, on
    the device activities' clock."""

    spans: List[Tuple[str, float, float, bool]] = field(default_factory=list)
    window: Interval = (0.0, 0.0)

    def host_state(self, t: float) -> str:
        """``in <span>`` for the span at the top of the main thread at ``t``,
        else ``in caller``."""
        for n, a, b, top in self.spans:
            if top and a <= t < b:
                return f"in {n}"
        return "in caller"

    def idle_gaps(self, k: int = 10) -> List[List]:
        """``trace.Trace.idle_gaps``, each name led by the host's state when
        the gap opened."""
        # when each gap opened, by its length (the same subtraction as the
        # plain gaps'), equal lengths in the order of time as there
        opened: Dict[float, List[float]] = {}
        end = None
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            if end is not None and a > end:
                opened.setdefault(a - end, []).append(end)
            end = b if end is None else max(end, b)
        return [[f"{self.host_state(opened[t].pop(0))} {name}", t]
                for name, t in super().idle_gaps(k)]


class SpanCapture(trace.Capture):
    """``trace.Capture`` with the program's spans recorded inside the
    profiler's window."""

    def start(self) -> None:
        from uno_tpu_torch.utils import start_recording

        super().start()
        start_recording()

    def stop(self) -> None:
        from uno_tpu_torch.utils import stop_recording

        self.recording = stop_recording()
        super().stop()

    def trace(self) -> SpanTrace:
        rec = self.recording
        base_ns = [rec.anchor[0]]  # without a device trace: the recording's start
        if self.prof is not None:
            export = self.prof.export_chrome_trace

            def export_reading_base(path: str) -> None:
                export(path)
                with open(path) as f:
                    base_ns[0] = int(json.load(f)["baseTimeNanoseconds"])

            self.prof.export_chrome_trace = export_reading_base
        tr = SpanTrace(**vars(super().trace()))

        def clock(perf_ns: int) -> float:
            return 1e-9 * (rec.epoch_ns(perf_ns) - base_ns[0])  # whole ns: exact

        main = threading.main_thread().ident
        tr.spans = [(n, clock(a), clock(b), parent is None)
                    for n, a, b, parent, thread in rec.spans if thread == main]
        tr.window = (clock(round(1e9 * self.t[0])), clock(round(1e9 * self.t[1])))
        return tr


def host_ms(r, name: str) -> Optional[float]:
    """The main thread's ms a traced step inside spans called ``name``."""
    spans = getattr(r.trace, "spans", None)
    if r.busy_s <= 0 or not spans:
        return None
    t = [b - a for n, a, b, _ in spans if n == name]
    return 1e3 * sum(t) / r.trace.steps if t else None


def idle_split(r) -> Optional[Tuple[float, float]]:
    """The window's ms a step with nothing on the device, split by whether
    the host's main thread was inside a span of the program (``grad``,
    ``optimizer``, a served ``forward``) or in none: (program, caller)."""
    tr = r.trace
    if r.busy_s <= 0 or not getattr(tr, "spans", None):
        return None
    idle = gaps(tr.window, union((a, b) for _, a, b in tr.device))
    total = sum(b - a for a, b in idle)
    program = overlap(idle, union((a, b) for _, a, b, top in tr.spans if top))
    return 1e3 * program / tr.steps, 1e3 * (total - program) / tr.steps
