"""A closed-loop trainer: the program's training step driven over the
shuffled batches of a training split resident on the device, in
``train_darcy``'s order (``uno_tpu_torch/train/darcy.py``): per step
``zero_grad``, ``dp_value_and_grad`` over the task's loss (Darcy: the
summed relative L2), ``ComplexAdam.step`` under its StepLR rate, the loss
(or what the task's ``logged`` gives) added to a device sum that is read
once an epoch.  No validation and no checkpoint.  The split, the program's
loss and the reference's are the configuration's task's; the reference's
Adam, StepLR and roundings its model family's (``benchmark/plugins.py``).

On more than one chip every rank is one process of the program's data
parallelism (``make_mesh``): each holds the split, takes its rows of every
global batch and sums the loss and gradients over the ranks (NCCL); the
ranks run a step count fixed in set-up from rank 0's warm steps, so that no
rank waits on a collective another has left.

``correct``: set-up drives the trainer from the seed through its first
``compared_steps`` steps, on rows that all differ, and hands it to the
window.  After the window the family's plain float32 reference follows
those steps from the same weights on the same rows, and the run compares
each step's loss, the first gradient as the optimizer took it (its first
moment after one step over ``1 - beta1``) and each parameter's change over
the steps, by the worst leaf's gap in norms, and the median leaf's gap in
the change, which is steadier from seed to seed.  Leaves whose reference
gradient is under a thousandth of the median leaf's (a bias just before an
instance norm) move by rounding alone and are left out of the change.  Each number is measured in units of the same
number for the reference rounded to bf16 where the configuration's policy
rounds (its own three steps): with random weights, how far rounding moves
these numbers varies several times from seed to seed.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import common, inputs, plugins, trace

TRAFFIC_KEYS = {"driver", "batch", "compared_steps", "warm_steps", "timing_steps", "trace_skip",
                "trace_steps"}
LIMIT_KEYS = {"loss_gap", "grad_gap", "change_gap", "change_median_gap"}


def _train_config(ctx: common.Context):
    from uno_tpu_torch.train.common import TrainConfig

    o = ctx.cfg["optimizer"]
    return TrainConfig(batch_size=ctx.traffic["batch"], learning_rate=o["lr"],
                       scheduler_step=o["scheduler_step_epochs"],
                       scheduler_gamma=o["scheduler_gamma"], weight_decay=o["weight_decay"],
                       seed=ctx.seed)


class Program:
    """The program's trainer: its model, optimizer and step."""

    def __init__(self, ctx: common.Context, w: Dict[str, torch.Tensor], steps_per_epoch: int):
        from uno_tpu_torch.parallel import dp_value_and_grad, place_state
        from uno_tpu_torch.train.common import make_optimizer

        task = plugins.task(ctx.cfg)
        model = common.program_model(ctx.cfg, w, ctx.device)
        place_state(ctx.dp, model)
        self.opt = make_optimizer(_train_config(ctx), steps_per_epoch, model.parameters())
        self.model = model
        self.logged = getattr(task, "logged", None)
        self.value_and_grad = dp_value_and_grad(task.program_loss(model, ctx.cfg), ctx.dp,
                                                model.parameters(),
                                                has_aux=self.logged is not None)
        self.beta1 = self.opt.param_groups[0]["betas"][0]

    def step(self, x, y, cap=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the step's loss, what it adds to the epoch's sum)."""
        self.opt.zero_grad(set_to_none=True)
        out, _ = self.value_and_grad(x, y)
        with trace.span(cap, "optimizer", cap is not None):
            self.opt.step()
        if self.logged is None:
            return out, out
        with torch.no_grad():
            return out[0], self.logged(out[1], y)

    def grads_only(self, x, y) -> None:
        """A forward and backward that leaves the state as it was."""
        self.value_and_grad(x, y)
        self.opt.zero_grad(set_to_none=True)

    def first_moment(self) -> Dict[str, torch.Tensor]:
        return {n: self.opt.state[p]["exp_avg"] for n, p in self.model.named_parameters()
                if p in self.opt.state}

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


class Control:
    """The reference in the program's place, its products and activations
    rounded to float8 where the configuration's policy rounds to bf16."""

    def __init__(self, ctx: common.Context, w: Dict[str, torch.Tensor], steps_per_epoch: int):
        if ctx.dp is not None:
            raise ValueError("the control steps one process over its own rows: run it on "
                             "one chip, where its rows are the global batch")
        o = ctx.cfg["optimizer"]
        self.cfg, self.ref = ctx.cfg, plugins.family(ctx.cfg)
        self.loss = plugins.task(ctx.cfg).reference_loss
        self.p = {k: v.clone().requires_grad_() for k, v in w.items()}
        self.adam = self.ref.Adam(self.p, self.ref.step_lr(o["lr"], o["scheduler_step_epochs"],
                                                           o["scheduler_gamma"], steps_per_epoch),
                                  o["weight_decay"], tuple(o["betas"]), o["eps"])
        self.beta1 = o["betas"][0]

    def step(self, x, y, cap=None) -> Tuple[torch.Tensor, torch.Tensor]:
        loss = self.loss(self.cfg, self.p, x, y, self.ref.fp8_round)
        grads = torch.autograd.grad(loss, list(self.p.values()))
        self.adam.step(dict(zip(self.p, grads)))
        loss = loss.detach()
        return loss, loss

    def grads_only(self, x, y) -> None:
        pass

    def first_moment(self) -> Dict[str, torch.Tensor]:
        return self.adam.mu

    def params(self) -> Dict[str, torch.Tensor]:
        return self.p


class Feed:
    """The program's batches (``device_batches``), epoch after epoch."""

    def __init__(self, ctx: common.Context, ntrain: int):
        self.args = (ntrain, _train_config(ctx), ctx.device)
        self.dp = ctx.dp
        self.rng = np.random.default_rng(ctx.seed)
        self.epoch: List[torch.Tensor] = []
        self.i = 0

    def next(self):
        """(this rank's rows of the next batch, whether it ends an epoch)."""
        from uno_tpu_torch.train.common import device_batches

        if self.i == len(self.epoch):
            self.epoch = device_batches(self.rng, *self.args, shuffle=True, dp=self.dp)
            self.i = 0
        self.i += 1
        return self.epoch[self.i - 1], self.i == len(self.epoch)


def _global_batches(ctx: common.Context, ntrain: int, k: int) -> List[np.ndarray]:
    """The first ``k`` global batches of the feed, every rank's rows."""
    from uno_tpu_torch.data.batching import epoch_batches

    return list(epoch_batches(np.random.default_rng(ctx.seed), ntrain, ctx.traffic["batch"],
                              shuffle=True, drop_remainder=ctx.dp is not None))[:k]


def _steps_per_epoch(ctx: common.Context) -> int:
    """As the trainer counts them: the remainder batch is dropped on a mesh."""
    ntrain, b = ctx.cfg["data"]["ntrain"], ctx.traffic["batch"]
    return ntrain // b if ctx.dp is not None else math.ceil(ntrain / b)


def _setup(ctx: common.Context):
    """Split, weights, trainer; the compared steps; their readings."""
    t = ctx.traffic
    ntrain = ctx.cfg["data"]["ntrain"]
    common.phase(ctx, "start")
    x, y = inputs.train_split(ctx.cfg, inputs.generator(ctx.seed, "train", ctx.device),
                              ntrain, ctx.device)
    w = inputs.weights(ctx.cfg, ctx.seed, ctx.device)
    common.phase(ctx, "split and weights")
    side = (Control if ctx.mode == "control" else Program)(ctx, w, _steps_per_epoch(ctx))
    common.phase(ctx, "trainer")
    w0 = common.host(w) if ctx.main else None
    del w
    feed = Feed(ctx, ntrain)
    losses, mu1 = [], None
    for k in range(t["compared_steps"]):
        idx, _ = feed.next()
        losses.append(side.step(x[idx], y[idx])[0])
        if k == 0 and ctx.main:
            mu1 = common.host(side.first_moment())
    common.phase(ctx, "compared steps")
    readings = {"losses": [float(v) for v in losses], "mu1": mu1,
                "p_end": common.host(side.params()) if ctx.main else None, "w0": w0,
                "beta1": side.beta1}
    if ctx.main:
        rows = np.concatenate(_global_batches(ctx, ntrain, t["compared_steps"]))
        readings["rows"] = (x[torch.from_numpy(rows).to(ctx.device)].cpu(),
                            y[torch.from_numpy(rows).to(ctx.device)].cpu())
    return x, y, side, feed, readings


def _reference_steps(ctx: common.Context, readings: dict, quant=None):
    """The reference's steps from the first weights on the compared rows:
    (each step's loss, the first moment after one step, the first step's
    gradient, the weights after the last step)."""
    o, b = ctx.cfg["optimizer"], ctx.traffic["batch"]
    ref, task = plugins.family(ctx.cfg), plugins.task(ctx.cfg)
    dev = ctx.device
    p = {k: v.to(dev, copy=True).requires_grad_() for k, v in readings["w0"].items()}
    adam = ref.Adam(p, ref.step_lr(o["lr"], o["scheduler_step_epochs"], o["scheduler_gamma"],
                                   _steps_per_epoch(ctx)),
                    o["weight_decay"], tuple(o["betas"]), o["eps"])
    xs, ys = readings["rows"]
    losses, raw1, mu1 = [], None, None
    for k in range(len(readings["losses"])):
        xb, yb = xs[k * b : (k + 1) * b].to(dev), ys[k * b : (k + 1) * b].to(dev)
        loss = task.reference_loss(ctx.cfg, p, xb, yb, quant)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        adam.step(grads)
        losses.append(float(loss.detach()))
        if k == 0:
            raw1 = {n: g.detach() for n, g in grads.items()}
            mu1 = {n: m.clone() for n, m in adam.mu.items()}
    return losses, mu1, raw1, {n: v.detach() for n, v in p.items()}


def _gaps(ctx, readings, side, ref, moved) -> Dict[str, float]:
    """The numbers of one side's steps against the reference's."""
    dev = ctx.device
    scale = 1.0 / (1.0 - readings["beta1"])
    w0 = {n: v.to(dev) for n, v in readings["w0"].items()}
    g_side = {n: m.to(dev) * scale for n, m in side["mu1"].items()}
    g_ref = {n: m * scale for n, m in ref["mu1"].items()}
    grads = [1.0] if set(g_ref) - set(g_side) else common.leaf_gaps(g_side, g_ref)
    changes = common.leaf_gaps({n: side["p_end"][n].to(dev) - w0[n] for n in w0},
                               {n: ref["p_end"][n] - w0[n] for n in w0}, moved)
    return {"loss_gap": max(abs(a - r) / abs(r) for a, r in zip(side["losses"], ref["losses"])),
            "grad_gap": max(grads), "change_gap": max(changes),
            "change_median_gap": float(np.median(changes))}


def _reference(ctx: common.Context, readings: dict) -> Dict[str, float]:
    """The reference's steps from the same weights on the same rows, and the
    numbers compared, each in units of the bf16 reference's."""
    keys = ("losses", "mu1", "raw1", "p_end")
    ref = dict(zip(keys, _reference_steps(ctx, readings)))
    bf16 = dict(zip(keys, _reference_steps(ctx, readings, plugins.family(ctx.cfg).bf16_round)))
    norms = {n: float(g.norm()) for n, g in ref["raw1"].items()}
    med = float(np.median(list(norms.values())))
    moved = [n for n in norms if norms[n] >= 1e-3 * med]
    prog = _gaps(ctx, readings, readings, ref, moved)
    unit = _gaps(ctx, readings, bf16, ref, moved)
    return {**{k: v / unit[k] for k, v in prog.items()},
            **{f"{k}_raw": v for k, v in prog.items()},
            **{f"{k}_unit": v for k, v in unit.items()},
            "unmoved_leaves": [n for n in norms if n not in moved]}


def _step_count(ctx: common.Context, side, feed, x, y) -> int:
    """On several ranks: the window's steps, from rank 0's warm steps."""
    import torch.distributed as dist

    common.sync(ctx.device)
    t0 = time.perf_counter()
    n = ctx.traffic["timing_steps"]
    for _ in range(n):
        idx, _ = feed.next()
        side.step(x[idx], y[idx])
    common.sync(ctx.device)
    per = (time.perf_counter() - t0) / n
    steps = torch.tensor([math.ceil(ctx.seconds / per)], device=ctx.device)
    dist.broadcast(steps, src=0)
    return int(steps.item())


def calibrate(ctx: common.Context) -> Dict[str, float]:
    """The numbers compared, without a window."""
    x, y, side, feed, readings = _setup(ctx)
    del x, y, side, feed
    common.release(ctx.device)
    return _reference(ctx, readings) if ctx.main else {}


def run(ctx: common.Context) -> dict:
    import torch.distributed as dist

    t = ctx.traffic
    common.reset_peak(ctx.device)
    x, y, side, feed, readings = _setup(ctx)
    ntrain = len(x)
    if ctx.dp is None and ntrain % t["batch"]:
        r = ntrain % t["batch"]  # the epoch's last, short batch
        side.grads_only(x[:r], y[:r])
    for _ in range(t["warm_steps"]):
        idx, _ = feed.next()
        side.step(x[idx], y[idx])
    fixed = _step_count(ctx, side, feed, x, y) if ctx.dp is not None else None
    common.sync(ctx.device)
    common.phase(ctx, "warm steps")
    setup_s = time.perf_counter() - ctx.t0

    cap = trace.Capture(ctx.device) if ctx.trace else None
    lo, hi = t["trace_skip"], t["trace_skip"] + t["trace_steps"]
    world = ctx.chips
    total = torch.zeros((), device=ctx.device)
    steps = samples = 0
    host = common.HostLoad()
    start = time.perf_counter()
    while (cap is not None and steps < hi) or (
            steps < fixed if fixed is not None else time.perf_counter() - start < ctx.seconds):
        if cap and steps == lo:
            common.sync(ctx.device)
            cap.start()
        idx, last = feed.next()
        total += side.step(x[idx], y[idx], cap if cap and lo <= steps < hi else None)[1]
        steps += 1
        samples += len(idx) * world
        if last:
            float(total)  # the epoch's one read, as the trainer makes it
            total = torch.zeros((), device=ctx.device)
        if cap and steps == hi:
            common.sync(ctx.device)
            cap.stop()
            cap.steps = hi - lo
    float(total)
    common.sync(ctx.device)
    window_s = time.perf_counter() - start
    host.report(window_s)

    peak = torch.tensor([float(common.peak_bytes(ctx.device))], device=ctx.device)
    tr = cap.trace() if cap else None
    busy = torch.tensor([tr.busy_s() if tr else 0.0], device=ctx.device)
    if ctx.dp is not None:
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
        dist.all_reduce(busy)
        busy /= world
    del x, y, side, feed
    common.release(ctx.device)
    numbers = _reference(ctx, readings) if ctx.main else {}
    return {"e2e": {"train_samples_per_s": samples / window_s,
                    "peak_mem_gib": float(peak) / 2**30, "setup_s": setup_s},
            "attempted": steps, "failed": 0, "memory_peak_bytes": int(float(peak)),
            "trace": tr, "busy_s": float(busy), "kind": "train", "batch": t["batch"],
            "numbers": numbers}
