"""Darcy flow trainer (port of ``uno_tpu/train/darcy.py``).

Behavioral contract from train_darcy.py:15-100: per-batch forward ->
relative-L2 (sum) -> backward -> Adam step; StepLR per epoch; validate every
epoch; keep the params on val improvement; reload the best for the final
test pass.  The same ``numpy`` batch order as ``uno_tpu``: one permutation
per train epoch from ``default_rng(cfg.seed)``; evaluation draws nothing.

Checkpoints, as in ``uno_tpu``: with ``cfg.checkpoint_dir`` the best params
are saved on each improvement (``best_params``), and the training state
(params, optimizer state with its step count, step, epoch, best val) every
``checkpoint_every`` epochs (those with ``epoch % checkpoint_every == 0``)
and on a graceful stop (``train_state``).  ``cfg.resume`` restores it and
continues from the next epoch.  Like ``uno_tpu``'s, a resumed run draws its
batch order from a fresh ``default_rng(cfg.seed)``: its first epoch visits
the batches of the first run's epoch 0, not those an uninterrupted run would
have visited; and its best params start unset, so unless val improves the
final test pass uses the last params.

Mechanics on the card: every split is moved to the model's device once; an
epoch's batch indices go over in one copy and batches are gathered there;
the losses are summed in a device tensor read once per epoch.  Nothing in a
step waits for the device, so the host queues the next step's kernels while
the card runs this one.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from uno_tpu_torch.data.batching import num_batches
from uno_tpu_torch.losses import relative_lp_loss
from uno_tpu_torch.train.checkpoint import CheckpointManager
from uno_tpu_torch.train.common import (
    BestTracker,
    GracefulStop,
    StepClock,
    TrainConfig,
    device_batches,
    lr_at,
    make_optimizer,
)
from uno_tpu_torch.train.metrics import MetricLogger


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
            for idx in device_batches(rng, n, cfg, device, shuffle=False):
                total += loss_fn(splits[ix][idx], splits[ix + 1][idx])
                count += len(idx)
        return float(total) / max(count, 1)

    ckpt = CheckpointManager(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
    best = BestTracker(ckpt)
    step = 0
    start_epoch = 0
    if cfg.resume and ckpt is not None and ckpt.exists("train_state"):
        restored = ckpt.restore("train_state")
        model.load_state_dict(restored["params"])
        opt.load_state_dict({"state": restored["optimizer"],
                             "param_groups": opt.state_dict()["param_groups"]})
        step = restored["step"]
        start_epoch = restored["epoch"] + 1
        best.best_val = restored["best_val"]

    def save_state(epoch: int) -> None:
        ckpt.save("train_state", {
            "params": model.state_dict(), "optimizer": opt.state_dict()["state"],
            "step": step, "epoch": epoch, "best_val": best.best_val,
        })

    stopped = False
    with GracefulStop() as stop:
        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.perf_counter()
            total = torch.zeros((), device=device)
            seen = 0
            clock = StepClock(device)
            clock.mark()
            for idx in device_batches(rng, ntrain, cfg, device, shuffle=True):
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
            if ckpt is not None and cfg.checkpoint_every and epoch % cfg.checkpoint_every == 0:
                save_state(epoch)
            if stop.requested:
                if ckpt is not None:
                    save_state(epoch)
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
