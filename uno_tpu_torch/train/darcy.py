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

Data parallelism, the counterpart of ``uno_tpu``'s ``mesh=``: with ``dp``
(``uno_tpu_torch.parallel``) every rank starts from rank 0's weights, runs
its rows of each global batch and applies the gradient summed over the
ranks (``dp_value_and_grad``), so the ranks keep the same weights bit for
bit.  As under ``uno_tpu``'s mesh the remainder batch is dropped, for
evaluation too, while the schedule's steps per epoch are still counted with
``cfg.drop_remainder``.  Only rank 0 logs and writes checkpoints; every rank
restores on resume.

A mesh with a ``spatial`` axis (``make_mesh(n_data, n_spatial)``), as in
``uno_tpu/train/darcy.py:62-76``: each rank of the axis keeps its rows of
the grid (``UNOModel.input_rows``) and runs the model split, or with
``cfg.tensor_parallel`` keeps the whole grid and its shard of every weight
(``train/common.py``).  The loss and every weight after a step equal the
one-process step's.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from uno_tpu_torch.data.batching import num_batches
from uno_tpu_torch.losses import relative_lp_loss
from uno_tpu_torch.parallel import DataParallel, dp_value_and_grad, place_state
from uno_tpu_torch.train.checkpoint import CheckpointManager
from uno_tpu_torch.train.common import (
    BestTracker,
    GracefulStop,
    StepClock,
    TrainConfig,
    barrier,
    check_data_parallel,
    device_batches,
    lr_at,
    make_optimizer,
    reduce_sums,
    resident,
    restore_train_state,
    sharded_params,
    spatial_axis,
    stop_on_any_rank,
    train_state,
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
    dp: Optional[DataParallel] = None,
) -> Dict[str, Any]:
    """Train ``model`` in place (its parameters are the initial weights, on
    its device) and leave the best-val weights loaded in it.  Returns the
    best state dict, the best val rel-L2, the test rel-L2 of the best
    weights, whether a signal stopped the run, the optimizer step count and
    this rank's ``step_ms`` per epoch."""
    main = dp is None or dp.main
    logger = logger or MetricLogger(tensorboard_dir=cfg.log_tensorboard if main else None)
    log = logger.log if main else (lambda record: None)
    world = check_data_parallel(cfg, dp)
    rng = np.random.default_rng(cfg.seed)
    s = y_train.shape[1]
    device = next(model.parameters()).device

    ntrain, nval, ntest = len(x_train), len(x_val), len(x_test)
    # counted with cfg.drop_remainder under data parallelism too, as uno_tpu does
    steps_per_epoch = num_batches(ntrain, cfg.batch_size, cfg.drop_remainder)
    place_state(dp, model, cfg.tensor_parallel)
    opt = make_optimizer(cfg, steps_per_epoch, model.parameters())
    axis = spatial_axis(cfg, dp)
    split = None if axis is None else axis.split(s)
    rows = None if axis is None else model.input_rows((s, s), axis)
    splits = resident((x_train, y_train, x_val, y_val, x_test, y_test), device, rows)

    def loss_fn(x, y):
        out = model(x, split=split).reshape(y.shape)
        return relative_lp_loss(out, y, reduction="sum", group=None if axis is None else axis.group)

    value_and_grad = dp_value_and_grad(loss_fn, dp, model.parameters(),
                                       sharded=sharded_params(model))

    def _eval(ix: int, n: int) -> float:
        total = torch.zeros((), device=device)
        count = 0
        with torch.no_grad():
            for idx in device_batches(rng, n, cfg, device, shuffle=False, dp=dp):
                total += loss_fn(splits[ix][idx], splits[ix + 1][idx])
                count += len(idx) * world
        return reduce_sums(dp, total)[0] / max(count, 1)

    ckpt = CheckpointManager(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
    best = BestTracker(ckpt if main else None, dp)
    step = 0
    start_epoch = 0
    if cfg.resume and ckpt is not None and ckpt.exists("train_state"):
        restored = restore_train_state(ckpt, model, opt, dp)
        step = restored["step"]
        start_epoch = restored["epoch"] + 1
        best.best_val = restored["best_val"]

    def save_state(epoch: int) -> None:
        state = train_state(model, opt, dp, step=step, epoch=epoch, best_val=best.best_val)
        if main:
            ckpt.save("train_state", state)
        barrier(dp)

    stopped = False
    step_ms = []
    with GracefulStop() as stop:
        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.perf_counter()
            total = torch.zeros((), device=device)
            seen = 0
            clock = StepClock(device)
            clock.mark()
            for idx in device_batches(rng, ntrain, cfg, device, shuffle=True, dp=dp):
                opt.zero_grad(set_to_none=True)
                loss, _ = value_and_grad(splits[0][idx], splits[1][idx])  # summed over ranks
                opt.step()
                total += loss
                seen += len(idx) * world
                step += 1
                clock.mark()
            train_l2 = float(total) / max(seen, 1)  # the epoch's one sync

            val_l2 = _eval(2, nval)
            dt = time.perf_counter() - t0
            improved = best.update(val_l2, model)
            if improved and ckpt is not None:
                barrier(dp)
            step_ms.append(clock.ms())
            log(
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
                    "step_ms": step_ms[-1],
                }
            )
            if ckpt is not None and cfg.checkpoint_every and epoch % cfg.checkpoint_every == 0:
                save_state(epoch)
            if stop_on_any_rank(dp, stop.requested):
                if ckpt is not None:
                    save_state(epoch)
                log({"task": "darcy", "stopped_early_after_epoch": epoch})
                stopped = True
                break

    if best.best_state is not None:
        model.load_state_dict(best.best_state)
    test_l2 = _eval(4, ntest) if ntest and not stopped else float("nan")
    if not stopped:
        log({"task": "darcy", "test_rel_l2": test_l2})
    return {
        "params": best.best_state if best.best_state is not None else model.state_dict(),
        "best_val": best.best_val,
        "test_rel_l2": test_l2,
        "stopped_early": stopped,
        "step": step,
        "step_ms": step_ms,
    }
