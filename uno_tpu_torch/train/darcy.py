"""Darcy flow trainer (port of ``uno_tpu/train/darcy.py``).

Behavioral contract from train_darcy.py:15-100: per-batch forward ->
relative-L2 (sum) -> backward -> Adam step; StepLR per epoch; validate every
epoch; keep the params on val improvement; reload the best for the final
test pass.  The same ``numpy`` batch order as ``uno_tpu``: one permutation
per train epoch from ``default_rng(cfg.seed)``; evaluation draws nothing.

Mechanics on the card: every split is moved to the model's device once; an
epoch's batch indices go over in one copy and batches are gathered there;
the losses are summed in a device tensor read once per epoch.  Nothing in a
step waits for the device, so the host queues the next step's kernels while
the card runs this one.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from uno_tpu_torch.data.batching import epoch_batches, num_batches
from uno_tpu_torch.losses import relative_lp_loss
from uno_tpu_torch.train.common import (
    BestTracker,
    GracefulStop,
    TrainConfig,
    lr_at,
    make_optimizer,
)
from uno_tpu_torch.train.metrics import MetricLogger


class _StepClock:
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


def _batches(rng, n, cfg: TrainConfig, device, shuffle: bool):
    """One epoch's index batches as device tensors (a single host->device
    copy: a per-batch copy of pageable memory would wait for the card)."""
    idx = list(epoch_batches(rng, n, cfg.batch_size, shuffle=shuffle,
                             drop_remainder=cfg.drop_remainder))
    if not idx:
        return []
    flat = torch.from_numpy(np.concatenate(idx)).to(device)
    return list(torch.split(flat, [len(i) for i in idx]))


def train_darcy(
    model: torch.nn.Module,
    x_train: np.ndarray,
    y_train: np.ndarray,
    x_val: np.ndarray,
    y_val: np.ndarray,
    x_test: np.ndarray,
    y_test: np.ndarray,
    cfg: TrainConfig,
    logger: Optional[MetricLogger] = None,
) -> Dict[str, Any]:
    """Train ``model`` in place (its parameters are the initial weights, on
    its device) and leave the best-val weights loaded in it.  Returns the
    best state dict, the best val rel-L2, the test rel-L2 of the best
    weights, whether a signal stopped the run, and the optimizer step
    count."""
    logger = logger or MetricLogger()
    rng = np.random.default_rng(cfg.seed)
    s = y_train.shape[1]
    device = next(model.parameters()).device

    ntrain, nval, ntest = len(x_train), len(x_val), len(x_test)
    steps_per_epoch = num_batches(ntrain, cfg.batch_size, cfg.drop_remainder)
    opt = make_optimizer(cfg, steps_per_epoch, model.parameters())
    splits = [
        torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
        for a in (x_train, y_train, x_val, y_val, x_test, y_test)
    ]

    def loss_fn(x, y):
        out = model(x).reshape(y.shape[0], s, s)
        return relative_lp_loss(out, y, reduction="sum")

    def _eval(ix: int, n: int) -> float:
        total = torch.zeros((), device=device)
        count = 0
        with torch.no_grad():
            for idx in _batches(rng, n, cfg, device, shuffle=False):
                total += loss_fn(splits[ix][idx], splits[ix + 1][idx])
                count += len(idx)
        return float(total) / max(count, 1)

    best = BestTracker()
    step = 0
    stopped = False
    with GracefulStop() as stop:
        for epoch in range(cfg.epochs):
            t0 = time.perf_counter()
            total = torch.zeros((), device=device)
            seen = 0
            clock = _StepClock(device)
            clock.mark()
            for idx in _batches(rng, ntrain, cfg, device, shuffle=True):
                opt.zero_grad(set_to_none=True)
                loss = loss_fn(splits[0][idx], splits[1][idx])
                loss.backward()
                opt.step()
                total += loss.detach()
                seen += len(idx)
                step += 1
                clock.mark()
            train_l2 = float(total) / max(seen, 1)  # the epoch's one sync

            val_l2 = _eval(2, nval)
            dt = time.perf_counter() - t0
            improved = best.update(val_l2, model)
            logger.log(
                {
                    "task": "darcy",
                    "epoch": epoch,
                    "step": step,
                    "lr": lr_at(cfg, steps_per_epoch, step),
                    "train_rel_l2": train_l2,
                    "val_rel_l2": val_l2,
                    "epoch_sec": dt,
                    "samples_per_sec": seen / dt,
                    "saved": improved,
                    "step_ms": clock.ms(),
                }
            )
            if stop.requested:
                logger.log({"task": "darcy", "stopped_early_after_epoch": epoch})
                stopped = True
                break

    if best.best_state is not None:
        model.load_state_dict(best.best_state)
    test_l2 = _eval(4, ntest) if ntest and not stopped else float("nan")
    if not stopped:
        logger.log({"task": "darcy", "test_rel_l2": test_l2})
    return {
        "params": best.best_state if best.best_state is not None else model.state_dict(),
        "best_val": best.best_val,
        "test_rel_l2": test_l2,
        "stopped_early": stopped,
        "step": step,
    }
