"""Each rank's training step time and peak device memory of the PyTorch
port's darcy_s211 on a mesh of CUDA cards, one process per card.

    python3 -m uno_tpu_torch.utils.mesh_run --mode none                   # one card
    torchrun --nproc-per-node 4 -m uno_tpu_torch.utils.mesh_run --mode dp        # 4 (data)
    torchrun --nproc-per-node 4 -m uno_tpu_torch.utils.mesh_run --mode tp        # 1 x 4, TP
    torchrun --nproc-per-node 4 -m uno_tpu_torch.utils.mesh_run --mode spatial   # 1 x 4, split
    torchrun --nproc-per-node 4 -m uno_tpu_torch.utils.mesh_run --mode dp-spatial  # 2 x 2

Trains darcy_s211's model (uno9, width 32, 211x211, global batch 16, bf16
policy, random weights from seed 0) with ``train_darcy`` for ``--epochs``
epochs of 4 steps on a synthetic split (64 train, 16 val, 16 test: standard
normal inputs, their local average as the target; made from seed 1 with
numpy on every rank) on ``cuda:LOCAL_RANK``, over NCCL.  As ``cli train``
does, the fused head is off on a mesh with a spatial axis.  Each rank
measures its own ``step_ms`` (CUDA events, ``train/common.py``) and
``torch.cuda.max_memory_allocated``; rank 0 prints the card (nvidia-smi
name and power limit) and one JSON line with every rank's warm step times
(the epochs after the first), peak memory and the per-epoch train loss.
Without a CUDA device it exits 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

from uno_tpu_torch import cli
from uno_tpu_torch.configs.presets import get_preset
from uno_tpu_torch.models import build_model
from uno_tpu_torch.ops.kernels import mlp_head
from uno_tpu_torch.parallel import initialize_from_env, make_mesh
from uno_tpu_torch.train.darcy import train_darcy
from uno_tpu_torch.train.metrics import MetricLogger

# mode -> (n_data, n_spatial) of a world of ranks
MESHES = {"none": None, "dp": lambda n: (n, 1), "tp": lambda n: (1, n),
          "spatial": lambda n: (1, n), "dp-spatial": lambda n: (2, n // 2)}
S, SPLIT = 211, (64, 16, 16)


class _Records(MetricLogger):
    def __init__(self):
        self.records = []

    def log(self, record):
        self.records.append(record)


def _split():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((sum(SPLIT), S, S, 1)).astype(np.float32)
    y = ((x[..., 0] + np.roll(x[..., 0], 1, 1) + np.roll(x[..., 0], 1, 2)) / 3.0)
    i, j = SPLIT[0], SPLIT[0] + SPLIT[1]
    return x[:i], y[:i], x[i:j], y[i:j], x[j:], y[j:]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--mode", choices=sorted(MESHES), required=True)
    p.add_argument("--epochs", type=int, default=3)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("mesh_run: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    cli._no_tf32()
    dp = None
    if args.mode != "none":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK") or 0))  # before NCCL starts
        initialize_from_env("nccl")
        n_data, n_spatial = MESHES[args.mode](dist.get_world_size())
        dp = make_mesh(n_data=n_data, n_spatial=n_spatial, device="cuda")
        if dp.spatial is not None:
            mlp_head.set_fused_head_mode(False)
    device = dp.device if dp is not None else torch.device("cuda", 0)
    preset = get_preset("darcy_s211")
    model = build_model(preset.model, dtype="bfloat16", device=device,
                        generator=torch.Generator().manual_seed(0), **preset.model_kwargs)
    cfg = dataclasses.replace(preset.train, epochs=args.epochs,
                              tensor_parallel=args.mode == "tp")
    rec = _Records()
    torch.cuda.reset_peak_memory_stats(device)
    out = train_darcy(model, *_split(), cfg, logger=rec, dp=dp)
    torch.cuda.synchronize(device)
    warm = [ms for ep in out["step_ms"][1:] for ms in ep]
    mine = torch.tensor([statistics.median(warm), min(warm), max(warm),
                         torch.cuda.max_memory_allocated(device) / 1e9], device=device)
    ranks = [mine]
    if dp is not None:
        ranks = [torch.zeros_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(ranks, mine)
    if dp is None or dp.main:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip().splitlines()
        print("\n".join(smi))
        print(json.dumps({
            "mode": args.mode, "world": len(ranks),
            "mesh": None if dp is None else [dp.world, 1 if dp.spatial is None
                                             else dp.spatial.world],
            "device": torch.cuda.get_device_name(device), "global_batch": cfg.batch_size,
            "train_rel_l2": [r["train_rel_l2"] for r in rec.records if "train_rel_l2" in r],
            "ranks": [dict(zip(("warm_ms_median", "warm_ms_fastest", "warm_ms_slowest",
                                "peak_gb"), [round(v, 4) for v in t.tolist()]))
                      for t in ranks]}))
    if dp is not None:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
