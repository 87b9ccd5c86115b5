"""NS-3D spatiotemporal trainer (port of ``uno_tpu/train/ns3d.py``).

Behavioral contract from ns_train_3d.py:15-147: one forward maps the T_in
input window to all T_f output steps at once (a 3-D U-NO over (x, y, t));
backward on the full-field relative-L2; the per-timestep losses are computed
without gradients and only logged; validation every ``cfg.eval_every``
epochs (those with ``epoch % eval_every == 0``); the best params are those
with the lowest **per-step** validation loss; the test pass, on the best
params, reports both.

Batches, checkpoints and resume follow ``uno_tpu_torch.train.darcy``: the
same ``numpy`` batch order as ``uno_tpu`` from ``default_rng(cfg.seed)``
(a resumed run redraws epoch 0's order, as ``uno_tpu``'s does), splits
resident on the model's device, losses summed there and read once per
epoch, ``step_ms`` from CUDA events.

Data parallelism (``dp``) as in ``uno_tpu_torch.train.darcy``: rank 0's
weights, each rank's rows of every global batch, the loss and gradients
summed over the ranks, the remainder batch dropped for evaluation too, only
rank 0 logging and writing checkpoints.  A mesh with a ``spatial`` axis
splits the grid's X axis over it, or with ``cfg.tensor_parallel`` shards
the weights (``uno_tpu/train/ns3d.py:62-76``; as in
``uno_tpu_torch.train.darcy``).
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


def forecast(model: torch.nn.Module, x: torch.Tensor, t_f: int, split=None) -> torch.Tensor:
    """x (B, S, S, T_in) -> the model's (B, S, S, T_f) forecast, f32 (with
    ``split``, this rank's rows of the first S).  ``model`` may be a served
    ``torch.export`` artifact, which takes no ``split``."""
    x5 = x.float()[..., None]
    out = model(x5) if split is None else model(x5, split=split)
    return out.reshape(*x.shape[:3], t_f)


def step_rel_l2(out: torch.Tensor, y: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over samples and time steps of each step's relative L2 (the
    reference's logged step loss); out, y (B, S, S, T), or a rank's rows of
    the first S with its ``group``."""
    n = out.shape[0] * out.shape[-1]
    return relative_lp_loss(out.movedim(-1, 1).reshape(n, -1), y.movedim(-1, 1).reshape(n, -1),
                            group=group)


def train_ns3d(
    model: torch.nn.Module,
    train_a: np.ndarray,
    train_u: np.ndarray,
    val_a: np.ndarray,
    val_u: np.ndarray,
    test_a: np.ndarray,
    test_u: np.ndarray,
    cfg: TrainConfig,
    t_f: int = 10,
    logger: Optional[MetricLogger] = None,
    dp: Optional[DataParallel] = None,
) -> Dict[str, Any]:
    """Train ``model`` in place (its parameters are the initial weights, on
    its device) and leave the best-val weights loaded in it.  Inputs are
    (N, S, S, T_in), targets (N, S, S, T_f).  Returns the best state dict,
    the best val step rel-L2, the test full-field and per-step rel-L2 of the
    best weights, whether a signal stopped the run, the optimizer step count
    and this rank's ``step_ms`` per epoch."""
    main = dp is None or dp.main
    logger = logger or MetricLogger(tensorboard_dir=cfg.log_tensorboard if main else None)
    log = logger.log if main else (lambda record: None)
    world = check_data_parallel(cfg, dp)
    rng = np.random.default_rng(cfg.seed)
    device = next(model.parameters()).device

    ntrain, nval, ntest = len(train_a), len(val_a), len(test_a)
    # counted with cfg.drop_remainder under data parallelism too, as uno_tpu does
    steps_per_epoch = num_batches(ntrain, cfg.batch_size, cfg.drop_remainder)
    place_state(dp, model, cfg.tensor_parallel)
    opt = make_optimizer(cfg, steps_per_epoch, model.parameters())
    axis = spatial_axis(cfg, dp)
    group = None if axis is None else axis.group
    split = None if axis is None else axis.split(train_a.shape[1])
    rows = None if axis is None else model.input_rows(train_a.shape[1:], axis)
    splits = resident((train_a, train_u, val_a, val_u, test_a, test_u), device, rows)

    def loss_fn(x, yy):
        out = forecast(model, x, t_f, split)
        return relative_lp_loss(out, yy, reduction="sum", group=group), out

    value_and_grad = dp_value_and_grad(loss_fn, dp, model.parameters(), has_aux=True,
                                       sharded=sharded_params(model))

    def _eval(ix: int, n: int):
        full_total = torch.zeros((), device=device)
        step_total = torch.zeros((), device=device)
        count = 0
        with torch.no_grad():
            for idx in device_batches(rng, n, cfg, device, shuffle=False, dp=dp):
                yy = splits[ix + 1][idx]
                out = forecast(model, splits[ix][idx], t_f, split)
                full_total += relative_lp_loss(out, yy, reduction="sum", group=group)
                step_total += step_rel_l2(out, yy, group)
                count += len(idx) * world
        count = max(count, 1)
        full_sum, step_sum = reduce_sums(dp, full_total, step_total)
        return full_sum / count, step_sum / (count * t_f)

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
                yy = splits[1][idx]
                opt.zero_grad(set_to_none=True)
                (_, out), _ = value_and_grad(splits[0][idx], yy)
                opt.step()
                with torch.no_grad():
                    total += step_rel_l2(out, yy, group)  # this rank's rows of the batch
                seen += len(idx) * world
                step += 1
                clock.mark()
            # the epoch's one sync
            train_loss = reduce_sums(dp, total)[0] / (max(seen, 1) * t_f)
            dt = time.perf_counter() - t0
            step_ms.append(clock.ms())

            record = {
                "task": "ns3d",
                "epoch": epoch,
                "step": step,
                "lr": lr_at(cfg, steps_per_epoch, step),
                "train_step_rel_l2": train_loss,
                "epoch_sec": dt,
                "samples_per_sec": seen / dt,
                "step_ms": step_ms[-1],
            }
            if epoch % cfg.eval_every == 0:
                val_full, val_step = _eval(2, nval)
                record["val_step_rel_l2"] = val_step
                record["val_full_rel_l2"] = val_full
                record["saved"] = best.update(val_step, model)
                if record["saved"] and ckpt is not None:
                    barrier(dp)
            log(record)
            if ckpt is not None and cfg.checkpoint_every and epoch % cfg.checkpoint_every == 0:
                save_state(epoch)
            if stop_on_any_rank(dp, stop.requested):
                if ckpt is not None:
                    save_state(epoch)
                log({"task": "ns3d", "stopped_early_after_epoch": epoch})
                stopped = True
                break

    if best.best_state is not None:
        model.load_state_dict(best.best_state)
    if ntest and not stopped:
        test_full, test_step = _eval(4, ntest)
        log({"task": "ns3d", "test_full_rel_l2": test_full, "test_step_rel_l2": test_step})
    else:
        test_full = test_step = float("nan")
    return {
        "params": best.best_state if best.best_state is not None else model.state_dict(),
        "best_val": best.best_val,
        "test_full_rel_l2": test_full,
        "test_step_rel_l2": test_step,
        "stopped_early": stopped,
        "step": step,
        "step_ms": step_ms,
    }
