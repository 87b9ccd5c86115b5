"""A copy of the benchmark with tiny cells, for the harness's CPU tests.

Each tiny configuration is a real one with every channel width cut by
``WIDTH / 32`` (the program's factories scale the same way), a 64x64 grid,
fewer training samples and a 3-step rollout; the tiny cells, traffic and
limits are new files beside the real ones, found by name as a later PR's
would be.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
WIDTH = 8

# set from the tiny cells' readings on the CPU over seeds 11-16 (program
# highest / control lowest); a training number is in units of the same
# number for the reference rounded to bf16, an answer in units of that
# reference's distance: train loss 1.61 / 8.0, median-leaf change 1.36 /
# 16.8 (half the batch reads 25 and more on the loss, an unchanged state 58
# and more, the exchange left out 99 and more); serve 1.7 / 10.6; rollout
# 1.17 / 14.9
TRAIN_LIMITS = {"loss_gap": 4.0, "grad_gap": 10.0, "change_gap": 50.0, "change_median_gap": 5.0}
LIMITS = {"tiny-train": TRAIN_LIMITS, "tiny-dp2-train": TRAIN_LIMITS,
          "tiny-serve": {"answer_gap": 5.0}, "tiny-rollout": {"answer_gap": 5.0}}
TRAIN = {"driver": "train_step", "batch": 4, "compared_steps": 3, "warm_steps": 1,
         "timing_steps": 2, "trace_skip": 1, "trace_steps": 2}
SERVE = {"driver": "serve_batch", "batch": 2, "pool_batches": 3, "warm_batches": 1,
         "sample_batches": 2, "trace_skip": 1, "trace_batches": 2}


def tiny_config(name: str) -> dict:
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    c = copy.deepcopy(cfg)
    m, f = c["model"], WIDTH / cfg["model"]["width"]
    for b in m["blocks"]:
        b["channels"] = int(b["channels"] * f)
    m["lift_hidden"] = int(m["lift_hidden"] * f)
    m["proj_hidden"] = int(m["proj_hidden"] * f)
    m["width"] = WIDTH
    c["program"]["kwargs"]["width"] = WIDTH
    c["name"] = f"tiny-{name}"
    c["grid"] = 64
    if c["task"] == "darcy":
        c["data"]["ntrain"] = 22  # not a multiple of the batch: a short last batch
    else:
        c["t_f"] = 3
    return c


def build(tmp: Path) -> Path:
    """The tree: the real benchmark plus the tiny cells."""
    root = tmp / "tree"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {"tiny-train": ("darcy_s211-uno9-bf16", "train", 1),
             "tiny-dp2-train": ("darcy_s211-uno9-bf16", "train", 2),
             "tiny-serve": ("darcy_s211-uno9-bf16", "serve", 1),
             "tiny-rollout": ("ns2d-uno-bf16", "serve", 1)}
    for cfg_name in {c for c, _, _ in cells.values()}:
        cfg = tiny_config(cfg_name)
        path = f"benchmark/configs/{cfg['name']}.json"
        (root / path).write_text(json.dumps(cfg))
        bench["configs"].append({"name": cfg["name"], "source": cfg["source"], "file": path,
                                 "reduced": [], "why": "tiny, for the harness's CPU tests"})
    for cell, (cfg_name, kind, chips) in cells.items():
        (root / "benchmark" / "traffic" / f"{cell}.json").write_text(
            json.dumps(TRAIN if kind == "train" else SERVE))
        (root / "benchmark" / "workloads" / f"{cell}.json").write_text(
            json.dumps({"limits": LIMITS[cell]}))
        bench["workloads"].append({"name": cell, "config": f"tiny-{cfg_name}", "traffic": cell,
                                   "chips": chips, "why": "tiny"})
        metric = "train_samples_per_s" if kind == "train" else "serve_samples_per_s"
        for m in bench["end_to_end"]:
            if m["name"] == metric:
                m["workloads"].append(cell)
        for m in bench["per_layer"]:
            if m["moves"] == metric and "workloads" in m:
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(root: Path, cell: str, *extra: str, seed: int = 2**31 + 11, seconds: float = 1.0,
        trace: int = 0, timeout: float = 600):
    """One run of the harness on the CPU in its own process: (returncode,
    stdout, stderr)."""
    cmd = [sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace), "--device", "cpu",
           "--root", str(root), *extra]
    p = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=timeout,
                       env={**os.environ, "PYTHONPATH": str(ROOT),
                            "OMP_NUM_THREADS": "2"})
    return p.returncode, p.stdout, p.stderr


def result(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])
