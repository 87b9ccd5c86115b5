"""Profiling and debugging hooks (port of ``uno_tpu/utils/profiling.py``),
and the port's spans.

* ``annotate(name)``: a span, as a context manager or a decorator.  Off
  (neither recording nor a ``trace`` capture on), it costs one flag check
  and returns a shared no-op: no clock read, no allocation, no torch call,
  no synchronisation.
* ``start_recording()`` / ``stop_recording()``: between the two, every span
  is one in-memory record on the host's ``perf_counter`` clock;
  ``stop_recording`` returns them with an anchor that puts them on the Unix
  epoch's clock, which a ``torch.profiler`` trace's device timestamps are
  on (its ``baseTimeNanoseconds`` plus ``ts``).  Nothing is written.
* ``trace(log_dir)``: a ``torch.profiler`` capture of the block (host ops,
  and the card's kernels and copies when there is a card), written as a
  Chrome trace into ``log_dir``; ``cli train --profile-dir`` wraps the run in
  it.  Inside it each span is also a ``record_function`` region, so the
  trace names the spans.  With no ``log_dir`` it does nothing.
* ``enable_nan_debugging()``: the nearest counterpart of ``jax_debug_nans``.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import socket
import threading
import time
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_NAN_HOOK = None  # the global forward hook while NaN debugging is on

# Spans: on while recording or inside ``trace``; the one flag ``annotate``
# reads when they are off.
_ON = False
_RECORDS: Optional[list] = None  # (seq, name, start, end, parent seq, thread)
_ANCHOR: Tuple[int, int] = (0, 0)
_CAPTURES = 0  # ``trace`` blocks open: spans are record_function regions too
_SEQ = itertools.count()  # a span's number, in the order spans open
_LOCAL = threading.local()  # each thread's stack of open spans


class _Region:
    """What ``annotate`` returns.  As a decorator, each call of the function
    is a span of its own, on or off as spans are when it is called."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)

        return spanned


class _Noop(_Region):
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, typ, value, tb) -> bool:
        return False


class _Noops(dict):
    """One shared no-op for each span name, made at its first use."""

    def __missing__(self, name: str) -> _Noop:
        noop = self[name] = _Noop(name)
        return noop


_NOOPS = _Noops()


class _Span(_Region):
    __slots__ = ("seq", "parent", "start", "region")

    def __enter__(self):
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        self.parent = stack[-1] if stack else None
        self.seq = next(_SEQ)
        stack.append(self.seq)
        self.region = record_function(self.name) if _CAPTURES else None
        if self.region is not None:
            self.region.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, typ, value, tb) -> bool:
        end = time.perf_counter_ns()
        if self.region is not None:
            self.region.__exit__(typ, value, tb)
        _LOCAL.stack.pop()
        records = _RECORDS
        if records is not None:
            records.append((self.seq, self.name, self.start, end, self.parent,
                            threading.get_ident()))
        return False


def annotate(name: str) -> _Region:
    """A span named ``name`` (a context manager, or a decorator).  While
    ``torch.compile`` or ``torch.export`` traces the program it is a no-op."""
    if not _ON:
        return _NOOPS[name]
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return _NOOPS[name]
    return _Span(name)


@dataclass(frozen=True)
class Recording:
    """The spans closed between ``start_recording`` and ``stop_recording``,
    in the order they opened: ``(name, start_ns, end_ns, parent, thread)``,
    times on ``time.perf_counter_ns``'s clock, ``parent`` the index in
    ``spans`` of the span open around it on its thread (None at the top),
    ``thread`` its ``threading.get_ident()`` (a CUDA backward runs on the
    autograd engine's thread).  ``anchor`` is ``(time.time_ns(),
    time.perf_counter_ns())`` read together at the start."""

    spans: List[Tuple[str, int, int, Optional[int], int]]
    anchor: Tuple[int, int]

    def epoch_ns(self, perf_ns: int) -> int:
        """A ``perf_counter_ns`` reading on the Unix epoch's clock."""
        return perf_ns + self.anchor[0] - self.anchor[1]


def start_recording() -> None:
    """Record every span in memory until ``stop_recording``."""
    global _ON, _RECORDS, _ANCHOR
    if _RECORDS is not None:
        raise RuntimeError("spans are already being recorded")
    a = time.perf_counter_ns()
    wall = time.time_ns()
    b = time.perf_counter_ns()
    _ANCHOR = (wall, (a + b) // 2)
    _RECORDS = []
    _ON = True


def stop_recording() -> Recording:
    """Stop recording; the spans recorded since ``start_recording``."""
    global _ON, _RECORDS
    if _RECORDS is None:
        raise RuntimeError("spans are not being recorded")
    records, _RECORDS = _RECORDS, None
    _ON = _CAPTURES > 0
    records.sort(key=lambda r: r[0])
    index = {r[0]: i for i, r in enumerate(records)}
    return Recording([(name, a, b, index.get(parent), thread)
                      for _, name, a, b, parent, thread in records], _ANCHOR)


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the block into ``log_dir/<host>_<pid>.<ns>.pt.trace.json``
    (one file per capture: the ranks of a data-parallel run and repeated
    captures do not collide), the program's spans named in it."""
    global _ON, _CAPTURES
    if not log_dir:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        _CAPTURES += 1
        _ON = True
        try:
            yield
        finally:
            _CAPTURES -= 1
            _ON = _CAPTURES > 0 or _RECORDS is not None
    prof.export_chrome_trace(
        os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}"
                              ".pt.trace.json"))


def _raise_on_non_finite(module, inputs, output) -> None:
    outs = output if isinstance(output, (tuple, list)) else (output,)
    for t in outs:
        if (isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())
                and not bool(torch.isfinite(t).all())):
            raise FloatingPointError(
                f"non-finite output of {type(module).__name__} {tuple(t.shape)} {t.dtype}")


def enable_nan_debugging(enable: bool = True) -> None:
    """Raise at the first module whose output has a NaN or an infinity, and
    at the first backward op that makes one (``torch.autograd``'s anomaly
    mode, which also names the forward op it came from).

    How it differs from ``jax_debug_nans``: JAX checks the output of every
    primitive, inside jitted code too, and re-runs it un-jitted to point at
    the op; here the forward is checked per module output, by a global
    forward hook on every ``nn.Module``, so a NaN made and consumed inside
    one module's forward is reported at that module, not at the op.  Each
    check reads a flag back from the card: a run is much slower with this on.
    """
    global _NAN_HOOK
    torch.autograd.set_detect_anomaly(enable)
    if enable and _NAN_HOOK is None:
        _NAN_HOOK = torch.nn.modules.module.register_module_forward_hook(_raise_on_non_finite)
    elif not enable and _NAN_HOOK is not None:
        _NAN_HOOK.remove()
        _NAN_HOOK = None
