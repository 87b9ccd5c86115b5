"""Batch inference, host to host, as the program's ``cli predict`` serves
it (``uno_tpu_torch/cli.py`` ``cmd_predict``): a batch of the client's
samples in host memory is copied to the card, the configuration's task
runs on it under ``inference_mode`` (its ``program_serve``; Darcy: one
forward; NS-2D: the ``make_rollout`` of ``t_f`` steps), and the prediction
is copied back.

One client serves in a closed loop: each request, a batch of ``batch``
samples, is sent as soon as the one before it has returned, so the card is
offered all it can take and the end-to-end metric is the samples completed
per second over the window.  A request's samples are a batch drawn from the
seed out of a pool of ``pool_batches`` distinct batches made in set-up;
every request shape is warmed before the window.

``correct``: a sample of ``sample_batches`` of the served requests, drawn
from the seed over all those completed (reservoir sampling), is run through
the plain float32 reference after the window (the task's
``reference_answer`` on the family's reference), and through the reference
rounded to bf16 where the configuration's policy rounds.  The number
compared, ``answer_gap``, is the worst sample's distance from the float32
answer over the bf16 reference's distance from it: the program's error in
units of its own precision's rounding at these weights and inputs, which
with random weights varies several times from seed to seed.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from benchmark import common, inputs, plugins, trace

TRAFFIC_KEYS = {"driver", "batch", "pool_batches", "warm_batches", "sample_batches",
                "trace_skip", "trace_batches"}
LIMIT_KEYS = {"answer_gap"}


def _program(ctx: common.Context, w: Dict[str, torch.Tensor]) -> Callable:
    """The program's serving call on a host batch."""
    model = common.program_model(ctx.cfg, w, ctx.device).eval()
    dev = ctx.device
    fwd = plugins.task(ctx.cfg).program_serve(model, ctx.cfg, dev)

    def serve(host_batch: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return fwd(host_batch.to(dev)).cpu()  # the copy to the host waits for the card

    return serve


def _reference(ctx: common.Context, w: Dict[str, torch.Tensor], quant=None) -> Callable:
    """The reference's answer to a host batch, on the card."""
    reference_answer = plugins.task(ctx.cfg).reference_answer

    def answer(host_batch: torch.Tensor) -> torch.Tensor:
        x = host_batch.to(ctx.device)
        with torch.no_grad():
            out = reference_answer(ctx.cfg, w, x, quant)
        return out.cpu()

    return answer


def _pool(ctx: common.Context) -> List[torch.Tensor]:
    t = ctx.traffic
    x = inputs.serve_inputs(ctx.cfg, inputs.generator(ctx.seed, "serve", ctx.device),
                            t["pool_batches"] * t["batch"], ctx.device).cpu()
    return list(x.split(t["batch"]))


class Reservoir:
    """A uniform sample of ``k`` of the completed requests, drawn from the
    seed: (pool index, answer)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, np.random.default_rng([seed, inputs.SEED_SALT["sample"]])
        self.kept: List[Tuple[int, torch.Tensor]] = []
        self.seen = 0

    def offer(self, j: int, out: torch.Tensor) -> None:
        if self.seen < self.k:
            self.kept.append((j, out))
        else:
            r = int(self.rng.integers(0, self.seen + 1))
            if r < self.k:
                self.kept[r] = (j, out)
        self.seen += 1


def _gap(ctx: common.Context, w, pool, kept) -> Dict[str, float]:
    ref, ref16 = _reference(ctx, w), _reference(ctx, w, plugins.family(ctx.cfg).bf16_round)
    ratio, raw = 0.0, 0.0
    for j, out in kept:
        want = ref(pool[j])
        d = common.sample_gaps(out, want)
        ratio = max(ratio, float((d / common.sample_gaps(ref16(pool[j]), want)).max()))
        raw = max(raw, float((d / common.sample_gaps(0 * want, want)).max()))
    return {"answer_gap": ratio, "answer_gap_raw": raw}


def calibrate(ctx: common.Context) -> Dict[str, float]:
    """The number compared over as many requests as a run compares: the
    program's (a short window), or the control's, served in turn."""
    t = ctx.traffic
    pool = _pool(ctx)
    w = inputs.weights(ctx.cfg, ctx.seed, ctx.device)
    if ctx.mode == "control":
        serve = _reference(ctx, w, plugins.family(ctx.cfg).fp8_round)
        kept = [(j, serve(pool[j])) for j in range(t["sample_batches"])]
    else:
        serve = _program(ctx, w)
        res = Reservoir(t["sample_batches"], ctx.seed)
        for i in range(max(t["sample_batches"], t["warm_batches"])):
            res.offer(i % len(pool), serve(pool[i % len(pool)]))
        kept = res.kept
        del serve
    common.release(ctx.device)
    return _gap(ctx, w, pool, kept)


def run(ctx: common.Context) -> dict:
    t = ctx.traffic
    common.reset_peak(ctx.device)
    common.phase(ctx, "start")
    pool = _pool(ctx)
    w = inputs.weights(ctx.cfg, ctx.seed, ctx.device)
    serve = _program(ctx, w)
    w = common.host(w)
    common.phase(ctx, "pool, weights and model")
    for i in range(t["warm_batches"]):
        serve(pool[i % len(pool)])
    common.phase(ctx, "warm batches")
    order = np.random.default_rng([ctx.seed, inputs.SEED_SALT["order"]])
    res = Reservoir(t["sample_batches"], ctx.seed)
    common.sync(ctx.device)
    setup_s = time.perf_counter() - ctx.t0

    cap = trace.Capture(ctx.device) if ctx.trace else None
    lo, hi = t["trace_skip"], t["trace_skip"] + t["trace_batches"]
    served = 0
    service = []
    host = common.HostLoad()
    start = time.perf_counter()
    while (cap is not None and served < hi) or time.perf_counter() - start < ctx.seconds:
        if cap and served == lo:  # each request ends in a copy to the host: synchronised
            cap.start()
        j = int(order.integers(len(pool)))
        t_req = time.perf_counter()
        res.offer(j, serve(pool[j]))
        service.append(time.perf_counter() - t_req)
        served += 1
        if cap and served == hi:
            cap.stop()
            cap.steps = hi - lo
    window_s = time.perf_counter() - start
    host.report(window_s)
    q = np.quantile(service, [0.1, 0.5, 0.9]) * 1e3
    print(f"window: {served} requests; service ms p10 {q[0]:.3f} p50 {q[1]:.3f} p90 {q[2]:.3f}",
          file=sys.stderr)

    peak = common.peak_bytes(ctx.device)
    tr = cap.trace() if cap else None
    del serve
    common.release(ctx.device)
    w = {k: v.to(ctx.device) for k, v in w.items()}
    numbers = _gap(ctx, w, pool, res.kept)
    return {"e2e": {"serve_samples_per_s": served * t["batch"] / window_s,
                    "peak_mem_gib": peak / 2**30, "setup_s": setup_s},
            "attempted": served, "failed": 0, "memory_peak_bytes": int(peak),
            "trace": tr, "busy_s": tr.busy_s() if tr else 0.0, "kind": "serve",
            "batch": t["batch"], "numbers": numbers}
