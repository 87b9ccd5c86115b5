"""A reference-budget training run of ``uno_tpu_torch`` on the card, timed.

    python3 tools/torch_budget_run.py darcy_s211 [--out-dir OUT] [--work-dir DIR]
    python3 tools/torch_budget_run.py ns3d_t40   [--out-dir OUT] [--work-dir DIR]

Each run is the two commands a user types, each in a process of its own:
``cli train --generate --data-cache --checkpoint-dir --log``, which makes
the split with the port's generator on the card and then trains at the
budget ``uno_tpu`` trained to its held-out accuracy, then ``cli eval
--checkpoint-dir`` of the best-val weights on the same split:

* ``darcy_s211``: the preset as it stands (uno9, 1500/250/250 at S = 211,
  700 epochs, batch 16), bf16, ``uno_tpu``'s 0.470% test rel-L2
  (``RESULTS.md``, ``runs/darcy_s211_full700_f32head.log``);
* ``ns3d_t40``: uno3d_t40 in f32 on 2048/128/128 trajectories of the fast
  generator profile, 80 epochs of batch 16, ``uno_tpu``'s 0.949% test
  full-field rel-L2 (``runs/ns3d_t40_q4.jsonl``).

The trainer's JSONL goes to ``OUT/torch_<run>.jsonl``, the eval line is
appended to it, and a summary to ``OUT/torch_<run>_summary.json``, also
printed as the last line: the card (``nvidia-smi``), each process's wall
clock, the set-up before the first output line of ``train`` (imports,
generation, the cache write and the model build: the generation time's
upper bound), the median ``step_ms`` of the steps after the first epoch, the
first epoch whose val reaches the target and the time to it (``epoch_sec``
summed up to that epoch, plus the set-up), and the test numbers.  The data
cache and checkpoints go to ``--work-dir`` (default: a fresh temporary
directory).  Exits non-zero if a command fails; a missed target is
reported, not an error.

    python3 tools/torch_budget_run.py darcy_s211 --table PORT.jsonl UNO_TPU.log

prints val rel-L2 at set epochs, the best, the first epoch at the target
and test of each log side by side (a markdown table; no card needed).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the epochs of the --table comparison (NS-3D validates on even epochs only)
TABLE_EPOCHS = {"darcy_s211": (1, 10, 100, 200, 400, 600),
                "ns3d_t40": (0, 2, 10, 20, 40, 60, 78)}

# name: (log stem, split and dtype flags, train flags, val key, test key, target)
RUNS = {
    "darcy_s211": ("torch_darcy_s211_full700", ["--dtype", "bfloat16"],
                   ["--checkpoint-every", "50"],
                   "val_rel_l2", "test_rel_l2", 0.0055),
    "ns3d_t40": ("torch_ns3d_t40_n2048",
                 ["--ntrain", "2048", "--nval", "128", "--ntest", "128", "--batch-size", "16",
                  "--dtype", "float32"],
                 ["--epochs", "80", "--checkpoint-every", "5"],
                 "val_full_rel_l2", "test_full_rel_l2", 0.0110),
}


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def _timed(cmd) -> tuple:
    """Run ``cmd`` with its output passed through; return its exit code,
    its wall clock and the seconds to its first output line."""
    t0 = time.perf_counter()
    first = None
    proc = subprocess.Popen(cmd, cwd=_ROOT, stdout=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONUNBUFFERED": "1"})
    for line in proc.stdout:
        if first is None:
            first = time.perf_counter() - t0
        sys.stdout.write(line)
        sys.stdout.flush()
    rc = proc.wait()
    return rc, time.perf_counter() - t0, first


def summarize(records, val_key: str, test_key: str, target: float) -> dict:
    """The numbers of one run's JSONL records: epochs, the median
    ``step_ms`` of the steps after the first epoch, the first epoch whose
    val reaches ``target`` with the ``epoch_sec`` summed up to it, the best
    val and the test lines."""
    epochs = [r for r in records if "epoch" in r]
    warm = [ms for r in epochs if r["epoch"] > 0 for ms in r.get("step_ms", [])]
    hit, sec = None, 0.0
    for r in epochs:
        sec += r["epoch_sec"]
        if r.get(val_key, float("inf")) <= target:
            hit = r["epoch"]
            break
    vals = [(r[val_key], r["epoch"]) for r in epochs if val_key in r]
    return {
        "epochs": len(epochs),
        "median_warm_step_ms": statistics.median(warm) if warm else None,
        "train_sec": sum(r["epoch_sec"] for r in epochs),
        "first_epoch_at_target": hit,
        "epoch_sec_to_target": sec if hit is not None else None,
        "best_val": min(vals)[0] if vals else None,
        "best_val_epoch": min(vals)[1] if vals else None,
        "test": [r[test_key] for r in records if test_key in r and "epoch" not in r],
    }


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def table(run: str, logs) -> str:
    """Markdown rows of val rel-L2 (%) at ``TABLE_EPOCHS[run]`` and at each
    log's best epoch, then test, one column per JSONL log."""
    _, _, _, val_key, test_key, target = RUNS[run]
    stats = [summarize(_records(path), val_key, test_key, target) for path in logs]
    vals = [{r["epoch"]: r[val_key] for r in _records(path) if val_key in r and "epoch" in r}
            for path in logs]

    def row(label, cells):
        return "| " + " | ".join([label] + cells) + " |"

    rows = [row("epoch", list(logs)), row("---", ["---"] * len(logs))]
    for e in TABLE_EPOCHS[run]:
        rows.append(row(f"val at {e}", [f"{v[e] * 100:.3f}" if e in v else "—" for v in vals]))
    rows.append(row("best val (epoch)", [f"{st['best_val'] * 100:.3f} ({st['best_val_epoch']})"
                                        for st in stats]))
    rows.append(row(f"first val <= {target * 100:g}", [str(st["first_epoch_at_target"])
                                                     for st in stats]))
    rows.append(row("test", [f"{st['test'][0] * 100:.3f}" for st in stats]))
    return "\n".join(rows)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("run", choices=sorted(RUNS))
    p.add_argument("--out-dir", default=os.path.join("build", "budget_runs"),
                   help="where the JSONL log and the summary go (default: build/budget_runs)")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--table", nargs="+", metavar="LOG",
                   help="print the val/test comparison of these JSONL logs and exit")
    args = p.parse_args(argv)
    if args.table:
        print(table(args.run, args.table))
        return 0
    stem, split, flags, val_key, test_key, target = RUNS[args.run]
    work = args.work_dir or tempfile.mkdtemp(prefix=f"{args.run}_")
    os.makedirs(work, exist_ok=True)
    os.makedirs(args.out_dir, exist_ok=True)
    log = os.path.join(os.path.abspath(args.out_dir), f"{stem}.jsonl")
    if os.path.exists(log):
        raise SystemExit(f"{log} exists: a run appends to its log, so start from none")
    data = ["--preset", args.run, "--data-cache", os.path.join(work, "split.npz"),
            "--device", "cuda"] + split
    ck = ["--checkpoint-dir", os.path.join(work, "ck")]
    cli = [sys.executable, "-m", "uno_tpu_torch.cli"]
    card = _card()
    print(card, flush=True)

    rc, train_s, setup_s = _timed(cli + ["train", "--generate"] + data + ck + flags
                                  + ["--log", log])
    if rc != 0:
        print(f"train exited {rc}", file=sys.stderr)
        return rc
    rc, eval_s, _ = _timed(cli + ["eval"] + data + ck + ["--log", log])
    if rc != 0:
        print(f"eval exited {rc}", file=sys.stderr)
        return rc

    records = _records(log)
    summary = {"run": args.run, "card": card, "flags": split + flags, "target": target,
               "train_wall_sec": train_s, "setup_sec": setup_s,
               "eval_wall_sec": eval_s, **summarize(records, val_key, test_key, target)}
    if summary["epoch_sec_to_target"] is not None:
        summary["time_to_target_sec"] = summary["epoch_sec_to_target"] + setup_s
    summary["test_at_target"] = bool(summary["test"]) and max(summary["test"]) <= target
    with open(os.path.join(args.out_dir, f"{stem}_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
