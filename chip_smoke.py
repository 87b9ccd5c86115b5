"""Smoke run of the PyTorch port (uno_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

It drives the port's serving path, Darcy ``darcy_s211`` batch inference with
model uno9 at full width (32) on the 211x211 grid, batch 16, under the bf16
mixed-precision policy, with random weights from a seed:

1. prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions and both TF32 flags (set off);
2. builds the CUDA kernels from ``uno_tpu_torch/csrc`` (nvcc, sm_90a);
3. holds each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it, and times both (median of per-launch
   CUDA events, L2 flushed before each launch);
4. runs ``python -m uno_tpu_torch.cli predict`` over a synthetic six-key
   darcy_s211 split (16 test samples) once to warm up and once measured,
   with the kernels' launch counters set to 0 just before the measured run;
   checks the output and that every kernel of the path launched;
5. runs the same weights on a 2-sample input on the card and on the CPU
   (f32 and bf16) and bounds the difference.

Any failed phase raises, and the script exits non-zero.  The line before the
last is ``{"kernels": [...]}``; the last line is ``{"ok": true, "device":
{...}}``.  Without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from uno_tpu_torch import cli
from uno_tpu_torch.bridge import params_from_flax, params_to_flax
from uno_tpu_torch.configs.presets import get_preset
from uno_tpu_torch.models import build_model
from uno_tpu_torch.ops.kernels import _build
from uno_tpu_torch.ops.kernels import cmul as cmul_k
from uno_tpu_torch.ops.kernels import mlp_head as head_k
from uno_tpu_torch.ops.spectral import spectral_weight_init

PRESET = "darcy_s211"
S, BATCH, NTEST = 211, 16, 16
# (B, Ci, Co, M = 2*m1*m2) of uno9's five spectral contractions at darcy_s211
CMUL_SHAPES = [(16, 32, 64, 648), (16, 64, 128, 128), (16, 128, 128, 128),
               (16, 128, 64, 128), (16, 128, 32, 648)]
# head: B, C (32 from block 4 + 32 from the lift skip), N = 211**2, H, O
HEAD_SHAPE = (16, 64, S * S, 32, 1)
CMUL_ATOL, HEAD_REL = 1e-4, 1e-5          # the CPU tests' bounds
E2E_REL = {"float32": 1e-4, "bfloat16": 3e-2}
REPS = 20


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-12))


def _time_ms(fn, flush: torch.Tensor, reps: int = REPS) -> list:
    """Per-launch device times in ms; the L2 cache is flushed before each."""
    events = []
    for _ in range(reps):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events]


def _turns(kernel, plain, flush):
    """Median ms of kernel and plain, timed in turns plain, kernel, kernel, plain."""
    p = _time_ms(plain, flush)
    k = _time_ms(kernel, flush) + _time_ms(kernel, flush)
    p += _time_ms(plain, flush)
    return statistics.median(k), statistics.median(p)


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    print(f"allow_tf32: cuda.matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.BUILD_SECONDS:.1f} s) under {_build.BUILD_DIR}")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("[build]", line.strip())


def phase_kernels(dev) -> dict:
    g = torch.Generator().manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    res = {}

    errs, k_ms, p_ms = [], [], []
    for b, ci, co, m in CMUL_SHAPES:
        # activations at unit scale, weights from the model's init distribution
        x = torch.complex(torch.randn(b, ci, m, generator=g),
                          torch.randn(b, ci, m, generator=g)).to(dev)
        w = spectral_weight_init(ci, co, (m,), 1, g, dev)[0].contiguous()
        got = cmul_k.cmul(x, w)
        want = cmul_k.cmul_plain(x, w)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not err <= CMUL_ATOL:
            raise AssertionError(f"cmul {(b, ci, co, m)}: max abs err {err} > {CMUL_ATOL}")
        km, pm = _turns(lambda: cmul_k.cmul(x, w), lambda: cmul_k.cmul_plain(x, w), flush)
        print(f"[kernels] cmul B={b} Ci={ci} Co={co} M={m}: max_abs_err {err:.3g} "
              f"kernel {km:.4f} ms  plain (complex einsum) {pm:.4f} ms")
        errs.append(err)
        k_ms.append(km)
        p_ms.append(pm)
    res["cmul"] = dict(max_abs_err=max(errs), ms=sum(k_ms), plain_ms=sum(p_ms))

    b, c, n, h, o = HEAD_SHAPE
    x = torch.randn(b, c, n, generator=g).to(dev, torch.bfloat16)
    bound = lambda *s: (torch.rand(*s, generator=g) * 2 - 1).to(dev)
    k1, b1 = bound(c, h) / c**0.5, bound(h) / c**0.5
    k2, b2 = bound(h, o) / h**0.5, bound(o) / h**0.5
    got = head_k.mlp_head(x, k1, b1, k2, b2)
    want = head_k.mlp_head_plain(x, k1, b1, k2, b2)
    torch.cuda.synchronize()
    rel, err = _rel(got, want), float((got - want).abs().max())
    if not rel <= HEAD_REL:
        raise AssertionError(f"mlp_head {HEAD_SHAPE}: rel-L2 {rel} > {HEAD_REL}")
    km, pm = _turns(lambda: head_k.mlp_head(x, k1, b1, k2, b2),
                    lambda: head_k.mlp_head_plain(x, k1, b1, k2, b2), flush)
    print(f"[kernels] mlp_head B={b} C={c} N={n} H={h} O={o}: rel-L2 {rel:.3g} "
          f"max_abs_err {err:.3g} kernel {km:.4f} ms  plain (unfused f32) {pm:.4f} ms")
    res["mlp_head"] = dict(max_abs_err=err, ms=km, plain_ms=pm)
    return res


def _write_split(path: str, rng) -> None:
    """A six-key darcy_s211 split with the signature uno_tpu's cli writes."""
    a = np.where(rng.standard_normal((NTEST, S, S, 1)) > 0, 12.0, 3.0).astype(np.float32)
    u = (0.01 * rng.standard_normal((NTEST, S, S))).astype(np.float32)
    ea, eu = np.zeros((0, S, S, 1), np.float32), np.zeros((0, S, S), np.float32)
    seed = get_preset(PRESET).train.seed
    sig = f"task=darcy,sub=2,ntrain=0,nval=0,ntest={NTEST},seed={seed}"
    np.savez(path, train_a=ea, train_u=eu, val_a=ea, val_u=eu, test_a=a, test_u=u,
             config_sig=np.asarray(sig))


def _predict(argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    sys.stdout.write(buf.getvalue())
    if rc != 0:
        raise AssertionError(f"predict returned {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def phase_predict(tmp: str) -> dict:
    data, out = os.path.join(tmp, "darcy_s211.npz"), os.path.join(tmp, "preds.npz")
    _write_split(data, np.random.default_rng(0))
    argv = ["predict", "--preset", PRESET, "--dtype", "bfloat16", "--init-seed", "0",
            "--data-cache", data, "--ntrain", "0", "--nval", "0", "--ntest", str(NTEST),
            "--split", "test", "--out", out, "--device", "cuda"]
    warm = _predict(argv)  # first run: cuFFT plans, cuBLAS handles, allocator
    cmul_k.LAUNCHES = 0
    head_k.LAUNCHES = 0
    report = _predict(argv)
    launches = {"cmul": cmul_k.LAUNCHES, "mlp_head": head_k.LAUNCHES}
    batches = len(report["batch_ms"])
    pred = np.load(out)["pred"]
    if pred.shape != (NTEST, S, S) or not np.isfinite(pred).all():
        raise AssertionError(f"predict output: shape {pred.shape}, finite {np.isfinite(pred).all()}")
    if launches["cmul"] < 5 * batches or launches["mlp_head"] != batches:
        raise AssertionError(f"kernel launches {launches} over {batches} batches")
    print(f"[predict] {PRESET} uno9 bf16 b{BATCH}: {batches} batch(es), ms per batch "
          f"{report['batch_ms']} (first run {warm['batch_ms']}); launches {launches}")
    return launches


def phase_cpu_vs_cuda(dev) -> None:
    rng = np.random.default_rng(1)
    x = torch.from_numpy(np.where(rng.standard_normal((2, S, S, 1)) > 0, 12.0, 3.0)
                         .astype(np.float32))
    kw = get_preset(PRESET).model_kwargs
    for dtype, bound in E2E_REL.items():
        cpu = build_model("uno9", dtype=dtype, generator=torch.Generator().manual_seed(0), **kw)
        gpu = build_model("uno9", dtype=dtype, device=dev, **kw)
        params_from_flax(gpu, params_to_flax(cpu))
        with torch.inference_mode():
            want = cpu(x)
            got = gpu(x.to(dev))
        rel = _rel(got, want)
        if not (torch.isfinite(got).all() and rel <= bound):
            raise AssertionError(f"cuda vs cpu, {dtype}: rel-L2 {rel} > {bound}")
        print(f"[cuda-vs-cpu] uno9 {S}x{S} b2 {dtype}: rel-L2 {rel:.3g} (bound {bound})")


def main() -> int:
    phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    times = phase_kernels(dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_predict(tmp)
    phase_cpu_vs_cuda(dev)
    kernels = [
        dict(name="cmul_fwd", route="cuda", source="uno_tpu_torch/csrc/cmul.cu",
             replaces="uno_tpu/ops/pallas/cmul.py:38", launches=launches["cmul"],
             **times["cmul"]),
        dict(name="mlp_head_fwd", route="cuda", source="uno_tpu_torch/csrc/mlp_head.cu",
             replaces="uno_tpu/ops/pallas/mlp_head.py:93", launches=launches["mlp_head"],
             **times["mlp_head"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
