"""Profiling and debugging hooks (port of ``uno_tpu/utils/profiling.py``).

* ``trace(log_dir)``: a ``torch.profiler`` capture of the block (host ops,
  and the card's kernels and copies when there is a card), written as a
  Chrome trace into ``log_dir``; ``cli train --profile-dir`` wraps the run in
  it.  With no ``log_dir`` it does nothing.
* ``annotate(name)``: a named region in the trace (a context manager or a
  decorator), ``torch.profiler.record_function``.
* ``enable_nan_debugging()``: the nearest counterpart of ``jax_debug_nans``.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_NAN_HOOK = None  # the global forward hook while NaN debugging is on


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the block into ``log_dir/<host>_<pid>.<ns>.pt.trace.json``
    (one file per capture: the ranks of a data-parallel run and repeated
    captures do not collide)."""
    if not log_dir:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}"
                              ".pt.trace.json"))


def annotate(name: str) -> record_function:
    """Decorator or context manager: a named region in profiler traces."""
    return record_function(name)


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
