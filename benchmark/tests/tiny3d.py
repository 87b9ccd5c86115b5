"""The ns3d configuration's tiny cell, added to ``tiny.py``'s copy of the
benchmark as new files, as a later PR's cell would be.

The tiny configuration is ``ns3d_t40-uno3d-f32`` at width 2 (every channel
count a quarter, as the program's factory scales them), on its own 64x64 grid:
the factory's modes (20, 14 and 6 a space axis) need the bottom block's 8
cells (64 / 8), so a smaller grid would change the model.  It keeps the 10
input frames, the blocks, their time factors and the crop, and holds 11
trajectories, trained in batches of 2 (``tiny.TRAIN``'s otherwise): the last
batch is short.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path

from benchmark.tests import tiny

WIDTH = 2
CELL = "tiny-ns3d-train"
# set from the tiny cell's readings on the CPU (program highest over seeds
# 11-30 / TF32 control lowest over 11-22), each number in units of the same
# number for the reference rounded to bf16 at the policy's points: worst-leaf
# gradient 0.0018 / 0.038 and median-leaf change 0.0011 / 0.042, the two that
# tell them apart; the loss (0.32 / 0.040: its unit, 4e-6 to 1.6e-4 with the
# seed, cancels) and the worst-leaf change (0.0030 / 0.0026) do not, and are
# held to what the faults break (an unchanged state reads 92 and more on the
# loss, half the batch 17 and more, and both 1.9 and more on the change)
TRAIN = dict(tiny.TRAIN, batch=2)
LIMITS = {"loss_gap": 1.0, "grad_gap": 0.008, "change_gap": 0.05, "change_median_gap": 0.007}


def tiny_config(width: int = WIDTH) -> dict:
    cfg = json.loads((tiny.ROOT / "benchmark/configs/ns3d_t40-uno3d-f32.json").read_text())
    c = copy.deepcopy(cfg)
    m = c["model"]
    f = width / m["width"]
    for b in m["blocks"]:
        b["channels"] = int(b["channels"] * f)
    m["lift_hidden"] = int(m["lift_hidden"] * f)
    m["proj_hidden"] = int(m["proj_hidden"] * f)
    m["width"] = width
    c["program"]["kwargs"]["width"] = width
    c["name"] = "tiny-ns3d_t40-uno3d-f32"
    c["data"]["ntrain"] = 11
    return c


def build(tmp: Path) -> Path:
    """``tiny.build``'s tree with the tiny ns3d cell added."""
    root = tiny.build(tmp)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = tiny_config()
    path = f"benchmark/configs/{cfg['name']}.json"
    (root / path).write_text(json.dumps(cfg))
    bench["configs"].append({"name": cfg["name"], "source": cfg["source"], "file": path,
                             "reduced": [], "why": "tiny, for the harness's CPU tests"})
    (root / "benchmark" / "traffic" / f"{CELL}.json").write_text(json.dumps(TRAIN))
    (root / "benchmark" / "workloads" / f"{CELL}.json").write_text(
        json.dumps({"limits": LIMITS}))
    bench["workloads"].append({"name": CELL, "config": cfg["name"], "traffic": CELL,
                               "chips": 1, "why": "tiny"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "train_samples_per_s" in (m["name"], m.get("moves")) and "workloads" in m:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
