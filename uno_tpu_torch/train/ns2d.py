"""NS-2D autoregressive rollout trainer (port of ``uno_tpu/train/ns2d.py``).

Behavioral contract from ns_train_2d.py:15-168: per batch, roll the model
forward ``T_f`` steps feeding each prediction back into the input window,
sum the per-step relative-L2, one backward through the **entire** rollout
(full BPTT).  Validation (the same rollout) every ``cfg.eval_every`` epochs
(those with ``epoch % eval_every == 0``); the best-val params are kept; the
test pass reports the per-step loss and the whole trajectory's rel-L2.

As in ``uno_tpu``, each step of the rollout is rematerialised
(``torch.utils.checkpoint``, non-reentrant, where ``uno_tpu`` has
``jax.checkpoint``): the forward keeps only each step's input window, and
the backward recomputes one step's activations at a time, so peak memory is
one step's activations instead of all ``T_f``.  The recompute runs each
step's forward once more, kernels included, and gives the same numbers.
With grad mode off (evaluation, serving) nothing is checkpointed or saved.

The fed-back window stays f32 under both precision policies: the head's
output is f32, and ``cat([xx[..., 1:], im])`` keeps it so.

Batches, checkpoints and resume follow ``uno_tpu_torch.train.darcy``: the
same ``numpy`` batch order as ``uno_tpu`` from ``default_rng(cfg.seed)``
(a resumed run redraws epoch 0's order, as ``uno_tpu``'s does), splits
resident on the model's device, losses summed there and read once per
epoch, ``step_ms`` from CUDA events.  The reference's scheduler bug
(stepping only on even epochs) is reproducible through
``cfg.compat_even_epoch_scheduler``.

Data parallelism (``dp``) as in ``uno_tpu_torch.train.darcy``: rank 0's
weights, each rank's rows of every global batch, the loss and gradients
summed over the ranks after the whole rollout's backward, the remainder batch dropped for
evaluation too, only rank 0 logging and writing checkpoints.  A mesh with a
``spatial`` axis splits the grid over it, or with ``cfg.tensor_parallel``
shards the weights (``uno_tpu/train/ns2d.py:93-105``; as in
``uno_tpu_torch.train.darcy``): every step of the rollout runs split, its
loss made whole over the axis.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

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


def make_rollout(model: torch.nn.Module, t_f: int, remat: bool = True, split=None):
    """Returns ``rollout(xx, yy) -> (step_loss_sum, pred)``: xx (B, S, S,
    T_in) the input window, yy (B, S, S, T_f) the targets, pred (B, S, S,
    T_f) f32.  With ``split`` (a ``parallel/spatial.py`` ``Split`` of S),
    xx and yy hold this rank's rows (``UNOModel.input_rows``) and so does
    pred; the losses are whole.  ``model`` may be a served ``torch.export``
    artifact of one step, which takes no ``split``."""
    group = None if split is None else split.group

    def one_step(xx, y_t):
        im = model(xx) if split is None else model(xx, split=split)  # (B, S, S, 1), f32
        loss_t = relative_lp_loss(im, y_t, reduction="sum", group=group)
        xx_next = torch.cat([xx[..., 1:], im], dim=-1)
        return xx_next, loss_t, im[..., 0]

    def rollout(xx: torch.Tensor, yy: torch.Tensor):
        xx = xx.float()
        losses, ims = [], []
        for t in range(t_f):
            y_t = yy[..., t : t + 1]
            if remat and torch.is_grad_enabled():
                # no random ops in the model: no RNG state to keep for the recompute
                xx, loss_t, im = checkpoint(one_step, xx, y_t, use_reentrant=False,
                                            preserve_rng_state=False)
            else:
                xx, loss_t, im = one_step(xx, y_t)
            losses.append(loss_t)
            ims.append(im)
        return torch.stack(losses).sum(), torch.stack(ims, dim=-1)

    return rollout


def train_ns2d(
    model: torch.nn.Module,
    train_a: np.ndarray,
    train_u: np.ndarray,
    val_a: np.ndarray,
    val_u: np.ndarray,
    test_a: np.ndarray,
    test_u: np.ndarray,
    cfg: TrainConfig,
    t_f: int = 40,
    logger: Optional[MetricLogger] = None,
    dp: Optional[DataParallel] = None,
) -> Dict[str, Any]:
    """Train ``model`` in place (its parameters are the initial weights, on
    its device) and leave the best-val weights loaded in it.  Returns the
    best state dict, the best val step rel-L2, the test step and trajectory
    rel-L2 of the best weights, whether a signal stopped the run, the
    optimizer step count and this rank's ``step_ms`` per epoch."""
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
    size = train_a.shape[1:3]
    split = None if axis is None else axis.split(size[0])
    rows = None if axis is None else model.input_rows(size, axis)
    splits = resident((train_a, train_u, val_a, val_u, test_a, test_u), device, rows)
    rollout = make_rollout(model, t_f, split=split)
    value_and_grad = dp_value_and_grad(lambda xx, yy: rollout(xx, yy)[0], dp,
                                       model.parameters(), sharded=sharded_params(model))

    def _eval(ix: int, n: int):
        step_total = torch.zeros((), device=device)
        traj_total = torch.zeros((), device=device)
        count = 0
        with torch.no_grad():
            for idx in device_batches(rng, n, cfg, device, shuffle=False, dp=dp):
                yy = splits[ix + 1][idx]
                loss, pred = rollout(splits[ix][idx], yy)
                step_total += loss
                traj_total += relative_lp_loss(pred, yy, reduction="sum",
                                               group=None if axis is None else axis.group)
                count += len(idx) * world
        count = max(count, 1)
        step_sum, traj_sum = reduce_sums(dp, step_total, traj_total)
        return step_sum / count / t_f, traj_sum / count

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
            train_loss = float(total) / max(seen, 1) / t_f  # the epoch's one sync
            dt = time.perf_counter() - t0
            step_ms.append(clock.ms())

            record = {
                "task": "ns2d",
                "epoch": epoch,
                "step": step,
                "lr": lr_at(cfg, steps_per_epoch, step),
                "train_step_rel_l2": train_loss,
                "epoch_sec": dt,
                "samples_per_sec": seen / dt,
                "step_ms": step_ms[-1],
            }
            if epoch % cfg.eval_every == 0:
                val_loss, val_traj = _eval(2, nval)
                record["val_step_rel_l2"] = val_loss
                record["val_traj_rel_l2"] = val_traj
                record["saved"] = best.update(val_loss, model)
                if record["saved"] and ckpt is not None:
                    barrier(dp)
            log(record)
            if ckpt is not None and cfg.checkpoint_every and epoch % cfg.checkpoint_every == 0:
                save_state(epoch)
            if stop_on_any_rank(dp, stop.requested):
                if ckpt is not None:
                    save_state(epoch)
                log({"task": "ns2d", "stopped_early_after_epoch": epoch})
                stopped = True
                break

    if best.best_state is not None:
        model.load_state_dict(best.best_state)
    if ntest and not stopped:
        test_step, test_traj = _eval(4, ntest)
        log({"task": "ns2d", "test_step_rel_l2": test_step, "test_traj_rel_l2": test_traj})
    else:
        test_step = test_traj = float("nan")
    return {
        "params": best.best_state if best.best_state is not None else model.state_dict(),
        "best_val": best.best_val,
        "test_step_rel_l2": test_step,
        "test_traj_rel_l2": test_traj,
        "stopped_early": stopped,
        "step": step,
        "step_ms": step_ms,
    }
