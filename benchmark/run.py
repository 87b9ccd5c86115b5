"""The benchmark of the PyTorch/CUDA port ``uno_tpu_torch``.

    python -m benchmark.run --workload CELL --seed N --seconds S --trace 0|1

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``,
its configuration's file (the entry's ``file``) with the model family and
the task that file names (``benchmark/plugins.py``), its traffic mix
(``benchmark/traffic/<traffic>.json``, whose ``driver`` names
``benchmark/traffic/<driver>.py``), its limits
(``benchmark/workloads/<cell>.json``) and each per-layer metric's reader
(``benchmark/metrics/<metric>.py``).

With ``--trace 0`` the last line of standard output is one JSON object
with the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics; its last key, ``checks``, and the last lines of standard error
give each number compared for ``correct`` beside its limit.  A cell on
several chips starts one process per card itself (NCCL); rank 0 prints.

Exits without a result when the card is missing or fewer cards than the
cell asks for are present, and when a JAX module was loaded.

``--calibrate SEEDS --mode M`` (not a benchmark run) prints the numbers
compared, per seed, for the program (``program``), the reference rounded to
float8 in its place (``control``), or the program with a fault planted
(``fault:<name>``, ``benchmark/faults.py``).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "uno_tpu"}
ROOT = Path(__file__).resolve().parents[1]


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A harness file by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"_bench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def cell_files(root: Path, name: str) -> dict:
    """The cell's entry and every file it names."""
    bench = _load_json(root / "BENCHMARK.json")
    (cell,) = [w for w in bench["workloads"] if w["name"] == name]
    (conf,) = [c for c in bench["configs"] if c["name"] == cell["config"]]
    traffic = _load_json(root / "benchmark" / "traffic" / f"{cell['traffic']}.json")

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return {"bench": bench, "entry": cell, "cfg": _load_json(root / conf["file"]),
            "traffic": traffic, "cell": _load_json(root / "benchmark" / "workloads" /
                                                   f"{name}.json"),
            "driver": root / "benchmark" / "traffic" / f"{traffic['driver']}.py",
            "end_to_end": e2e, "per_layer": per_layer}


def _parse(argv):
    p = argparse.ArgumentParser(prog="python -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # not used by a benchmark run: calibration, tests, and the ranks it starts
    p.add_argument("--calibrate", default=None, help="comma-separated seeds")
    p.add_argument("--mode", default="program")
    p.add_argument("--device", default="cuda", help="cpu: the harness's own tests")
    p.add_argument("--root", default=str(ROOT))
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--port", type=int, default=0)
    return p.parse_args(argv)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _start_ranks(argv, world: int, port: int, root: Path):
    env = dict(os.environ)
    procs = []
    for r in range(1, world):
        cmd = [sys.executable, "-m", "benchmark.run", *argv, "--rank", str(r),
               "--port", str(port)]
        procs.append(subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.DEVNULL))
    return procs


def _stop_ranks(procs, ok: bool) -> None:
    for p in procs:
        if not ok:
            p.kill()
        try:
            p.wait(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _per_layer(files, res, chips: int, device_name: str) -> dict:
    from benchmark import counts

    tr = res["trace"]
    if tr is None or not tr.steps:
        return {}
    r = SimpleNamespace(trace=tr, busy_s=res["busy_s"], cfg=files["cfg"], batch=res["batch"],
                        chips=chips, kind=res["kind"], peak=counts.peaks(device_name))
    out = {}
    for m in files["per_layer"]:
        v = load_module(Path(files["root"]) / "benchmark" / "metrics" / f"{m['name']}.py").read(r)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parse(argv)
    root = Path(args.root)
    files = cell_files(root, args.workload)
    files["root"] = str(root)
    chips = files["entry"]["chips"]

    import torch

    if args.device == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < chips):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() {torch.cuda.is_available()}, {n} found",
              file=sys.stderr)
        return 2

    from benchmark import common, faults

    common.set_precision()
    torch.set_num_threads(1)  # the host's work is launches: one thread, steadier runs
    procs = []
    dp = None
    if args.device == "cuda":
        torch.cuda.set_device(args.rank)
        device = torch.device("cuda", args.rank)
    else:
        device = torch.device("cpu")
    if chips > 1:
        import datetime

        import torch.distributed as dist

        from uno_tpu_torch.parallel import make_mesh

        port = args.port or _free_port()
        if args.rank == 0:
            procs = _start_ranks(argv, chips, port, root)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{port}", world_size=chips,
                                rank=args.rank, timeout=datetime.timedelta(seconds=300))
        dp = make_mesh(n_data=chips, device=device)
    ok = False
    try:
        driver = load_module(files["driver"])
        seeds = [int(s) for s in args.calibrate.split(",")] if args.calibrate else [args.seed]
        for mode in args.mode.split(","):
            for seed in seeds:
                ctx = common.Context(cfg=files["cfg"], traffic=files["traffic"], seed=seed,
                                     seconds=args.seconds, trace=bool(args.trace),
                                     device=device, chips=chips, dp=dp, mode=mode, t0=T0)
                with faults.planted(mode):
                    if args.calibrate:
                        numbers = driver.calibrate(ctx)
                        if ctx.main:
                            verdict = common.verdict(numbers, files["cell"]["limits"])
                            print(json.dumps({"calibrate": args.workload, "mode": mode,
                                              "seed": seed, **numbers,
                                              "correct": verdict["correct"]}), flush=True)
                        continue
                    res = driver.run(ctx)
        ok = True
        if args.calibrate or args.rank != 0:
            return 0
    finally:
        if dp is not None:
            import torch.distributed as dist

            dist.destroy_process_group()
        _stop_ranks(procs, ok)

    found = forbidden_modules()
    if found:
        print(f"benchmark: modules of JAX or of the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    failed = [p.args for p in procs if p.returncode != 0]
    if failed:
        print(f"benchmark: ranks failed: {failed}", file=sys.stderr)
        return 4
    verdict = common.verdict(res["numbers"], files["cell"]["limits"])
    device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    if args.trace:
        metrics = _per_layer(files, res, chips, device_name if device.type == "cuda" else "H100")
    else:
        metrics = {m["name"]: {"value": res["e2e"][m["name"]], "unit": m["unit"]}
                   for m in files["end_to_end"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": device_name,
           "count": chips, "memory_peak_bytes": res["memory_peak_bytes"],
           "power": _power_limit() if device.type == "cuda" else "none"}
    line = {"correct": verdict["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": dev}
    if args.trace and res["trace"] is not None:
        tr = res["trace"]
        dev["busy_s"] = res["busy_s"]
        dev["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    line["checks"] = verdict["checks"]
    for k, c in verdict["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
