"""Device busy time and idle share of the PyTorch port's serving batch and
training step on one CUDA card, for an NS or a Darcy preset.

    python3 tools/torch_ns2d_profile.py [--preset ns2d|ns3d_t40|darcy_s211|darcy_s421] \
        [--dtype bfloat16|float32] [--reps 5] [--trace-dir DIR] [--by-op]

Builds the preset's model at full width with the ``--dtype`` policy (bf16
by default; the benchmark's ns3d_t40 configuration is f32) and random
weights from seed 0 on ``cuda:0`` (``ns2d``: ``uno``, width 32, 64x64,
batch 16, T_f 40; ``ns3d_t40``: ``uno3d_t40``, width 8, 64x64, batch 16,
T_in 10 -> T_f 40; ``darcy_s211``: ``uno9``, width 32, 211x211, batch 16;
``darcy_s421``: ``uno11``, width 32, 421x421, batch 4) and times two
calls:

* serving: the ``cli predict`` batch without its host copies, under
  ``torch.inference_mode()``: for ns2d one 40-step rollout, for ns3d_t40
  one 3-D forward to all 40 steps, for Darcy one forward;
* exported serving: the same batch through the model's ``torch.export``
  artifact (``uno_tpu_torch.export``, exported on the card at the batch's
  shape and loaded back) in place of the eager model: for ns2d the
  rollout calls the exported step 40 times;
* training: one step of the preset's trainer, then ComplexAdam: for ns2d
  ``train_ns2d``'s (the checkpointed 40-step rollout and its backward
  through every step), for ns3d_t40 ``train_ns3d``'s (the forward, the
  full-field loss's backward, the per-step losses without gradients), for
  Darcy ``train_darcy``'s (the forward, the summed rel-L2's backward).

For each it reports the warm time between CUDA events recorded before and
after the call, unprofiled (the median of ``--reps``; idle gaps where the
card waits for the host count); then one more call under
``torch.profiler`` (CPU and CUDA activities), from whose trace it counts the
kernels launched and the device busy time (the union of the kernels',
copies' and sets' intervals), and lists the kernels that took the most
time, and the aten ops the host dispatched with those that took the most
host time under the profiler.  The idle share is 1 - busy / the
unprofiled time.  With ``--by-op`` each call's line also puts every device
activity down to the chain of CPU ops and autograd nodes above the op
that launched it, sorted into a class by its name (``copy``,
``memcpy_dtod``, ``fill``, ``complex_add``, ``float_add``, ``fft``,
``remap``, ``other``): the ms of each class and its chains that took the
most; and counts the ops that the 3-D FFT path's autograd used to run
(``slice_backward``, ``select_backward``, ``_fft_c2c``) by the autograd
node they ran under.  Inputs and targets are standard normal: the work does
not depend on the values.

Prints the card (nvidia-smi name and power limit) and one JSON line per
call.  Without a CUDA device it exits 1.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from uno_tpu_torch.configs.presets import get_preset  # noqa: E402
from uno_tpu_torch.data.batching import num_batches  # noqa: E402
from uno_tpu_torch.export import export_forward, load_forward  # noqa: E402
from uno_tpu_torch.models import build_model  # noqa: E402
from uno_tpu_torch.train.common import make_optimizer  # noqa: E402
from uno_tpu_torch.losses import relative_lp_loss  # noqa: E402
from uno_tpu_torch.train.ns2d import make_rollout  # noqa: E402
from uno_tpu_torch.train.ns3d import forecast, step_rel_l2  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WATCHED = ("aten::slice_backward", "aten::select_backward", "aten::_fft_c2c")
# ops left out of a chain above the launching op: allocations and casts
SKIP = ("aten::empty", "aten::empty_strided", "aten::to", "aten::_to_copy")


def _event_ms(fn, reps: int) -> list:
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return times


def _busy(trace_path: str) -> dict:
    """Kernels, busy ms (union of device intervals) and the top kernels of a
    chrome trace."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        if e["cat"] == "kernel":
            by_name[e["name"]][0] += 1
            by_name[e["name"]][1] += e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {
        "kernels": sum(1 for e in events if e["cat"] == "kernel"),
        "copies_and_sets": sum(1 for e in events if e["cat"] != "kernel"),
        "busy_ms": busy / 1e3,
        "kernel_ms": sum(v[1] for v in by_name.values()) / 1e3,
        "top_kernels": [{"name": n[:90], "count": c, "ms": round(us / 1e3, 4)}
                        for n, (c, us) in top],
    }


def _class(name: str) -> str:
    if "Memcpy DtoD" in name or "Memcpy Device to Device" in name:
        return "memcpy_dtod"
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return "memcpy_other"
    if "remap_kernel" in name:
        return "remap"
    if "fft" in name:
        return "fft"
    if "copy_kernel" in name:
        return "copy"
    if "FillFunctor" in name:
        return "fill"
    if "CUDAFunctor_add" in name or "AddFunctor" in name:
        return "complex_add" if "complex" in name else "float_add"
    return "other"


def _node(evt) -> str:
    """The autograd node an op ran under, or "-"."""
    e = evt.cpu_parent
    while e is not None and "evaluate_function" not in e.name:
        e = e.cpu_parent
    return "-" if e is None else e.name.split(": ")[-1]


def _chain(evt) -> str:
    """The launching op and the non-aten ops and autograd nodes above it."""
    names, e = [], evt
    while e is not None:
        if (e is evt or not e.name.startswith("aten::") or e.cpu_parent is None) \
                and e.name not in SKIP:
            names.append(e.name.replace("autograd::engine::evaluate_function: ", "bwd:"))
        e = e.cpu_parent
    return " > ".join(reversed(names))


def _by_op(prof) -> dict:
    """Every device activity of one call by class, and the watched ops."""
    chains = collections.defaultdict(lambda: collections.defaultdict(lambda: [0, 0.0]))
    watched = collections.Counter()
    for evt in prof.profiler.function_events:
        if evt.name in WATCHED:
            watched[f"{evt.name} under {_node(evt)}"] += 1
        for k in evt.kernels:
            c = chains[_class(k.name)][_chain(evt)]
            c[0] += 1
            c[1] += k.duration / 1e3  # us -> ms
    classes = {}
    for cls, by_chain in sorted(chains.items()):
        top = sorted(by_chain.items(), key=lambda kv: -kv[1][1])[:8]
        classes[cls] = {"ms": round(sum(v[1] for v in by_chain.values()), 4),
                        "count": sum(v[0] for v in by_chain.values()),
                        "top_chains": [{"chain": ch[-200:], "count": n, "ms": round(ms, 4)}
                                       for ch, (n, ms) in top]}
    return {"classes": classes, "watched": dict(sorted(watched.items()))}


def _measure(name: str, fn, reps: int, trace_dir, preset: str, by_op: bool) -> dict:
    fn()
    fn()  # warm: cuFFT plans, cuBLAS handles, the allocator
    torch.cuda.synchronize()
    wall = _event_ms(fn, reps)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    path = os.path.join(trace_dir or tempfile.mkdtemp(), f"{preset}_{name}.json")
    prof.export_chrome_trace(path)
    stats = _busy(path)
    med = statistics.median(wall)
    # host side: aten ops dispatched, and where the host's time went (times
    # under the profiler, which slows the host; the shares are what count)
    ops = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    host = sorted(ops, key=lambda e: -e.self_cpu_time_total)[:8]
    extra = {"by_op": _by_op(prof)} if by_op else {}
    return {"call": name, "wall_ms_median": med, "wall_ms": wall,
            "idle_share": 1.0 - stats["busy_ms"] / med, **stats,
            "aten_ops": sum(e.count for e in ops),
            "top_host_ops": [{"name": e.key, "count": e.count,
                              "self_cpu_ms": round(e.self_cpu_time_total / 1e3, 3)}
                             for e in host],
            "trace": path if trace_dir else None, **extra}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="ns2d",
                    choices=["ns2d", "ns3d_t40", "darcy_s211", "darcy_s421"])
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--trace-dir", default=None, help="keep the chrome traces here")
    ap.add_argument("--by-op", action="store_true",
                    help="put each call's device time down to the ops that launched it")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_ns2d_profile: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    preset = get_preset(args.preset)
    bs, t_f, s = preset.train.batch_size, preset.t_f, preset.size
    darcy = preset.task == "darcy"
    if darcy:
        s, t_f = (421 - 1) // preset.sub + 1, None
    model = build_model(preset.model, dtype=args.dtype, device=dev,
                        generator=torch.Generator().manual_seed(0), **preset.model_kwargs)
    rng = np.random.default_rng(0)
    x_shape, y_shape = ((bs, s, s, 1), (bs, s, s)) if darcy else (
        (bs, s, s, preset.t_in), (bs, s, s, t_f))
    xx = torch.from_numpy(rng.standard_normal(x_shape).astype(np.float32)).to(dev)
    yy = torch.from_numpy(rng.standard_normal(y_shape).astype(np.float32)).to(dev)
    opt = make_optimizer(preset.train, num_batches(preset.ntrain, bs), model.parameters())
    step_in = xx if darcy else xx[..., None] if preset.task == "ns3d" else xx
    exported = load_forward(export_forward(model, step_in))

    if darcy:
        def serve(m=model):
            with torch.inference_mode():
                m(xx)

        def train_step():
            opt.zero_grad(set_to_none=True)
            out = model(xx).reshape(yy.shape)
            relative_lp_loss(out, yy, reduction="sum").backward()
            opt.step()
    elif preset.task == "ns2d":
        rollout = make_rollout(model, t_f)

        def serve(m=model):
            with torch.inference_mode():
                make_rollout(m, t_f)(xx, torch.zeros_like(yy))

        def train_step():
            opt.zero_grad(set_to_none=True)
            loss, _ = rollout(xx, yy)
            loss.backward()
            opt.step()
    else:
        def serve(m=model):
            with torch.inference_mode():
                forecast(m, xx, t_f)

        def train_step():
            opt.zero_grad(set_to_none=True)
            out = forecast(model, xx, t_f)
            relative_lp_loss(out, yy).backward()
            opt.step()
            with torch.no_grad():
                step_rel_l2(out, yy)

    calls = (("serving_batch", serve), ("exported_serving_batch", lambda: serve(exported)),
             ("training_step", train_step))
    for name, fn in calls:
        print(json.dumps({"preset": args.preset, "model": preset.model, "dtype": args.dtype,
                          "batch": bs, "t_f": t_f,
                          **_measure(name, fn, args.reps, args.trace_dir, args.preset,
                                     args.by_op)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
