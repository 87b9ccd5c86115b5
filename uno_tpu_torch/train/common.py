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

On a mesh with a ``spatial`` axis (``uno_tpu``'s ``spatial`` mesh axis) the
trainers either split the grid over it, as ``uno_tpu``'s ``DataPlacer``
constrains the batch to ``P("data", "spatial")`` (``spatial_axis``: each
rank keeps only its rows of every split on the device, ``resident``), or,
with ``cfg.tensor_parallel``, shard the weights over it and keep the whole
grid (``parallel/tp.py``).  Checkpoints hold whole tensors in a one-process
run's layout: under TP every rank gathers and rank 0 writes
(``train_state``), and a resumed run keeps its shards (``restore_train_state``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from uno_tpu_torch.data.batching import epoch_batches
from uno_tpu_torch.optim import ComplexAdam, step_lr
from uno_tpu_torch.parallel.mesh import DataParallel, shard_batch
from uno_tpu_torch.parallel.spatial import Axis
from uno_tpu_torch.parallel.tp import full_state, local_state, sharded_axes
from uno_tpu_torch.train.checkpoint import CheckpointManager


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
    # channel tensor parallelism over the mesh's spatial axis (parallel/tp.py)
    tensor_parallel: bool = False


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
    when there is a checkpoint manager.  With ``dp`` under channel TP the
    copy holds this rank's shards, and every rank gathers the whole tensors
    that rank 0 saves (call ``update`` on every rank)."""

    def __init__(self, ckpt: Optional[CheckpointManager] = None,
                 dp: Optional[DataParallel] = None):
        self.best_val = float("inf")
        self.best_state: Optional[Dict[str, torch.Tensor]] = None
        self.ckpt = ckpt
        self.dp = dp

    def update(self, val: float, model: torch.nn.Module) -> bool:
        if val < self.best_val:
            self.best_val = val
            self.best_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
            whole = full_state(model, self.dp, self.best_state)
            if self.ckpt is not None:
                self.ckpt.save("best_params", whole)
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


def reduce_sums(dp: Optional[DataParallel], *sums: torch.Tensor) -> List[float]:
    """Device scalars summed over the ``data`` ranks in one collective, then
    read (one synchronisation).  The ranks of a ``spatial`` axis hold the
    same sums (their losses are whole), so they are not summed over it."""
    t = torch.stack(sums)
    if dp is not None and dp.group is not None:
        dist.all_reduce(t, group=dp.group)
    return t.tolist()


def stop_on_any_rank(dp: Optional[DataParallel], requested: bool) -> bool:
    """True on every rank of the mesh when a stop was requested on any: the
    ranks stop after the same epoch instead of one waiting for the others in
    the next collective."""
    if dp is None or dp.mesh_group is None:
        return requested
    flag = torch.tensor([int(requested)], device=dp.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=dp.mesh_group)
    return bool(flag.item())


def barrier(dp: Optional[DataParallel]) -> None:
    """Wait until every rank of the mesh gets here (after rank 0 writes a
    checkpoint)."""
    if dp is not None and dp.mesh_group is not None:
        flag = torch.zeros(1, device=dp.device)
        dist.all_reduce(flag, group=dp.mesh_group)
        flag.item()


def spatial_axis(cfg: TrainConfig, dp: Optional[DataParallel]) -> Optional[Axis]:
    """The axis the trainers split the grid over: the mesh's ``spatial``
    axis, unless it carries channel TP (``cfg.tensor_parallel``)."""
    if dp is None or dp.spatial is None or cfg.tensor_parallel:
        return None
    return dp.spatial


def resident(arrays, device, rows=None) -> List[torch.Tensor]:
    """Each split array on ``device`` as f32, once; with ``rows`` (lo, hi)
    only those rows of its axis 1, the first grid axis (a split run keeps
    only its rows on the device)."""
    lo, hi = rows if rows is not None else (None, None)
    return [torch.from_numpy(np.ascontiguousarray(a[:, lo:hi], np.float32)).to(device)
            for a in arrays]


def sharded_params(model: torch.nn.Module) -> List[torch.nn.Parameter]:
    """The parameters that hold a channel shard (none without TP)."""
    axes = sharded_axes(model)
    return [p for n, p in model.named_parameters() if n in axes]


def _opt_by_name(model, opt_state: dict, fn) -> dict:
    """``fn`` applied to the optimizer state's tensors, each keyed by its
    parameter's name (the optimizer holds ``model.parameters()`` in order)."""
    names = [n for n, _ in model.named_parameters()]
    out = {}
    for i, st in opt_state.items():
        tensors = {k: v for k, v in st.items() if torch.is_tensor(v)}
        done = {k: fn({names[i]: v})[names[i]] for k, v in tensors.items()}
        out[i] = {**st, **done}
    return out


def train_state(model, opt, dp: Optional[DataParallel], **extra) -> Dict[str, Any]:
    """The full training state in a one-process run's layout: params,
    optimizer state and ``extra`` (step, epoch, best val).  Under TP every
    rank gathers; the caller writes it on rank 0."""
    whole = lambda state: full_state(model, dp, state)  # noqa: E731
    return {"params": whole(model.state_dict()),
            "optimizer": _opt_by_name(model, opt.state_dict()["state"], whole), **extra}


def restore_train_state(ckpt: CheckpointManager, model, opt, dp: Optional[DataParallel]):
    """Load ``train_state`` into ``model`` and ``opt`` (this rank's shards
    under TP); returns the restored dict."""
    restored = ckpt.restore("train_state")
    mine = lambda state: local_state(model, dp, state)  # noqa: E731
    model.load_state_dict(mine(restored["params"]))
    opt.load_state_dict({"state": _opt_by_name(model, restored["optimizer"], mine),
                         "param_groups": opt.state_dict()["param_groups"]})
    return restored
