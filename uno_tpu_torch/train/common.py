"""Shared trainer machinery (port of ``uno_tpu/train/common.py``): config,
optimizer wiring, the logged learning rate, graceful stop, best-val tracking;
and, for the trainers, the step clock, an epoch's batches on the device and
what data parallelism adds to an epoch.

``uno_tpu``'s ``DataPlacer`` (TPU tile-padding layouts, host-resident
fallback) and ``DeviceAccumulator`` (a relay workaround) are not ported: the
trainer moves each split to the card once, indexes batches there and sums
losses in a device tensor that it reads once per epoch.  Its mesh branch is
``device_batches`` with a ``DataParallel`` rank: every rank draws the same
permutation and keeps its rows of each global batch; the epoch's sums are
summed over the ranks when they are read (``reduce_sums``), and a stop
requested on any rank stops them all after the epoch (``stop_on_any_rank``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, fields
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from uno_tpu_torch.data.batching import epoch_batches
from uno_tpu_torch.optim import ComplexAdam, step_lr
from uno_tpu_torch.parallel.mesh import DataParallel, shard_batch
from uno_tpu_torch.train.checkpoint import CheckpointManager

# fields the port does not implement yet -> the ROADMAP item that brings them
_NOT_PORTED = {
    "tensor_parallel": "ROADMAP.md Queue 1 item 8 (channel tensor parallelism on DTensor)",
}


@dataclass
class TrainConfig:
    epochs: int = 150
    batch_size: int = 16
    learning_rate: float = 1e-3
    scheduler_step: int = 100        # epochs between StepLR decays
    scheduler_gamma: float = 0.5
    weight_decay: float = 1e-4
    seed: int = 0
    eval_every: int = 1              # validate every k epochs (reference NS: 2)
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0        # full-state checkpoint every k epochs
    resume: bool = False
    drop_remainder: bool = False
    # Reference ns_train_2d.py steps the scheduler only on even epochs
    # (:74,:113 — effective step size 2x nominal).  Off by default; enable to
    # bit-match the reference schedule.
    compat_even_epoch_scheduler: bool = False
    log_tensorboard: Optional[str] = None
    # uno_tpu's channel tensor-parallelism (parallel/tp.py)
    tensor_parallel: bool = False

    def __post_init__(self):
        for f in fields(self):
            if f.name in _NOT_PORTED and getattr(self, f.name) != f.default:
                raise NotImplementedError(
                    f"TrainConfig.{f.name}={getattr(self, f.name)!r} is not ported "
                    f"yet: {_NOT_PORTED[f.name]}"
                )


def _sched_epochs(cfg: TrainConfig) -> int:
    return cfg.scheduler_step * (2 if cfg.compat_even_epoch_scheduler else 1)


def make_optimizer(cfg: TrainConfig, steps_per_epoch: int, params) -> ComplexAdam:
    schedule = step_lr(cfg.learning_rate, _sched_epochs(cfg), cfg.scheduler_gamma,
                       steps_per_epoch)
    return ComplexAdam(params, lr=schedule, weight_decay=cfg.weight_decay)


def lr_at(cfg: TrainConfig, steps_per_epoch: int, step: int) -> float:
    """Learning rate in effect at optimizer step ``step`` (for logging)."""
    epoch = max(step - 1, 0) // steps_per_epoch
    return cfg.learning_rate * cfg.scheduler_gamma ** (epoch // _sched_epochs(cfg))


class GracefulStop:
    """Preemption-safe shutdown: on SIGTERM/SIGINT, finish the current epoch
    and return early.

    Install with ``with GracefulStop() as stop:`` around the epoch loop and
    poll ``stop.requested`` at epoch boundaries.  Previous handlers are
    restored on exit; a second signal falls through to them (so a double
    Ctrl-C still kills a run immediately).
    """

    SIGNALS = ("SIGTERM", "SIGINT")

    def __init__(self):
        self.requested = False
        self._prev = {}

    def _handler(self, signum, frame):
        import signal

        self.requested = True
        # restore previous disposition: next signal is not swallowed
        signal.signal(signum, self._prev.get(signum, signal.SIG_DFL))

    def __enter__(self):
        import signal
        import threading

        if threading.current_thread() is not threading.main_thread():
            return self  # handlers only installable from the main thread
        for name in self.SIGNALS:
            sig = getattr(signal, name)
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except (ValueError, OSError):  # non-main interpreter contexts
                pass
        return self

    def __exit__(self, *exc):
        import signal

        for sig, prev in self._prev.items():
            try:
                if signal.getsignal(sig) == self._handler:
                    signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        return False


class BestTracker:
    """Reference best-val selection: keep a copy of the model's state dict,
    on its device, whenever val improves, and save it as ``best_params``
    when there is a checkpoint manager."""

    def __init__(self, ckpt: Optional[CheckpointManager] = None):
        self.best_val = float("inf")
        self.best_state: Optional[Dict[str, torch.Tensor]] = None
        self.ckpt = ckpt

    def update(self, val: float, model: torch.nn.Module) -> bool:
        if val < self.best_val:
            self.best_val = val
            self.best_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
            if self.ckpt is not None:
                self.ckpt.save("best_params", self.best_state)
            return True
        return False


class StepClock:
    """Per-step times in ms without a synchronisation per step.  On a card,
    CUDA events recorded on the stream at each step boundary and read after
    the epoch's one synchronisation: a step's time is the device's time
    between two boundaries, idle gaps waiting for the host included.  On
    the CPU, where every op is synchronous, the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List[Any] = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def ms(self) -> List[float]:
        """Call after the device has passed the last mark."""
        pairs = zip(self.marks, self.marks[1:])
        if self.cuda:
            return [a.elapsed_time(b) for a, b in pairs]
        return [(b - a) * 1e3 for a, b in pairs]


def device_batches(rng, n: int, cfg: TrainConfig, device, shuffle: bool,
                   dp: Optional[DataParallel] = None):
    """One epoch's index batches as device tensors (a single host->device
    copy: a per-batch copy of pageable memory would wait for the card).

    With ``dp``, as under ``uno_tpu``'s mesh (``uno_tpu/train/darcy.py:69``):
    the remainder batch is dropped, for evaluation too, and each batch is
    this rank's rows of the global one."""
    drop = cfg.drop_remainder or dp is not None
    idx = [shard_batch(dp, i) for i in epoch_batches(rng, n, cfg.batch_size, shuffle=shuffle,
                                                     drop_remainder=drop)]
    if not idx:
        return []
    flat = torch.from_numpy(np.concatenate(idx)).to(device)
    return list(torch.split(flat, [len(i) for i in idx]))


def check_data_parallel(cfg: TrainConfig, dp: Optional[DataParallel]) -> int:
    """The world size (1 without ``dp``); raises unless it divides the batch."""
    if dp is None:
        return 1
    if cfg.batch_size % dp.world:
        raise ValueError(f"batch size {cfg.batch_size} does not split over {dp.world} ranks")
    return dp.world


def _has_group(dp: Optional[DataParallel]) -> bool:
    return dp is not None and dp.group is not None


def reduce_sums(dp: Optional[DataParallel], *sums: torch.Tensor) -> List[float]:
    """Device scalars summed over the ranks in one collective, then read
    (one synchronisation)."""
    t = torch.stack(sums)
    if _has_group(dp):
        dist.all_reduce(t, group=dp.group)
    return t.tolist()


def stop_on_any_rank(dp: Optional[DataParallel], requested: bool) -> bool:
    """True on every rank when a stop was requested on any: the ranks stop
    after the same epoch instead of one waiting for the others in the next
    collective."""
    if not _has_group(dp):
        return requested
    flag = torch.tensor([int(requested)], device=dp.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=dp.group)
    return bool(flag.item())


def barrier(dp: Optional[DataParallel]) -> None:
    """Wait until every rank gets here (after rank 0 writes a checkpoint)."""
    if _has_group(dp):
        reduce_sums(dp, torch.zeros((), device=dp.device))
