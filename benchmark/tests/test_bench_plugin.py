"""A configuration of another model family joins the benchmark by new files
alone.  In a copy of the tiny tree the test adds a family module under a
new name whose schema has a block key that uno2d lacks, a task whose trainer
adds what its ``logged`` gives to the epoch's sum, a driver of its own that
declares its keys, a configuration naming the family and the task, and a
cell.  The schema tests pass on the copy, the cell runs on the CPU and
prints a correct line, and no file that was in the copy before changed:
``BENCHMARK.json`` only gained the new entries.  A configuration holding a
key that its family does not declare is refused."""

from __future__ import annotations

import copy
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

from benchmark.tests import tiny

SEED = 2**31 + 31
FILES = {
    "benchmark/reference/plug2d.py": '''"""The plug-in test's family: uno2d with a block
key of its own, ``tag``, which the model does not read."""

from benchmark.reference import uno2d
from benchmark.reference.uno2d import *  # noqa: F401,F403

BLOCK_KEYS = uno2d.BLOCK_KEYS | {"tag"}


def check_spec(spec, model):
    blocks = [{k: v for k, v in b.items() if k != "tag"} for b in model["blocks"]]
    uno2d.check_spec(spec, dict(model, blocks=blocks))
''',
    "benchmark/tasks/plug_darcy.py": '''"""The plug-in test's task: Darcy, its trainer
adding each step's mean absolute error to the epoch's sum where
``train_darcy`` adds the loss."""

import sys

from benchmark.tasks.darcy import *  # noqa: F401,F403


def program_loss(model, cfg):
    from uno_tpu_torch import losses

    def loss_fn(x, y):
        out = model(x).reshape(y.shape)
        return losses.relative_lp_loss(out, y, reduction="sum"), out.detach()

    return loss_fn


def logged(out, y):
    print("logged a step", file=sys.stderr)
    return (out - y).abs().mean()
''',
    "benchmark/traffic/plug_step.py": '''"""The plug-in test's driver: train_step's
closed loop under traffic keys of its own, and one limit."""

import dataclasses
from pathlib import Path

from benchmark.run import load_module

TRAFFIC_KEYS = {"driver", "batch", "steps_compared", "steps_warm", "steps_traced"}
LIMIT_KEYS = {"loss_gap"}
_base = load_module(Path(__file__).with_name("train_step.py"))


def _ctx(ctx):
    t = ctx.traffic
    return dataclasses.replace(ctx, traffic={
        "batch": t["batch"], "compared_steps": t["steps_compared"],
        "warm_steps": t["steps_warm"], "timing_steps": 2, "trace_skip": 1,
        "trace_steps": t["steps_traced"]})


def run(ctx):
    return _base.run(_ctx(ctx))


def calibrate(ctx):
    return _base.calibrate(_ctx(ctx))
''',
    "benchmark/traffic/tiny-plug.json": json.dumps(
        {"driver": "plug_step", "batch": 4, "steps_compared": 3, "steps_warm": 1,
         "steps_traced": 2}),
    "benchmark/workloads/tiny-plug.json": json.dumps({"limits": {"loss_gap": 4.0}}),
}


def _config(name: str, reference: str, task: str) -> dict:
    cfg = tiny.tiny_config("darcy_s211-uno9-bf16")
    cfg.update(name=name, reference=reference, task=task)
    for i, b in enumerate(cfg["model"]["blocks"]):
        b["tag"] = f"block {i}"
    return cfg


def _add_config(root: Path, bench: dict, cfg: dict) -> None:
    path = f"benchmark/configs/{cfg['name']}.json"
    (root / path).write_text(json.dumps(cfg))
    bench["configs"].append({"name": cfg["name"], "source": cfg["source"], "file": path,
                             "reduced": [], "why": "the plug-in test's"})


def _hashes(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts and p.name != "BENCHMARK.json"}


def _schema_tests(root: Path, select: str):
    """The copy's own ``test_bench_files.py`` run on the copy."""
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rA", "-p", "no:cacheprovider",
         "benchmark/tests/test_bench_files.py", "-k", select],
        cwd=root, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(tiny.ROOT), "OMP_NUM_THREADS": "2"})


def test_a_family_a_task_a_driver_and_a_cell_join_by_new_files(tmp_path):
    root = tiny.build(tmp_path)
    before, bench0 = _hashes(root), json.loads((root / "BENCHMARK.json").read_text())
    bench = copy.deepcopy(bench0)
    for path, text in FILES.items():
        assert not (root / path).exists()
        (root / path).write_text(text)
    _add_config(root, bench, _config("tiny-plug", "plug2d", "plug_darcy"))
    bench["workloads"].append({"name": "tiny-plug", "config": "tiny-plug", "traffic": "tiny-plug",
                               "chips": 1, "why": "the plug-in test's"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "train_samples_per_s" in (m["name"], m.get("moves")) and "workloads" in m:
            m["workloads"].append("tiny-plug")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    p = _schema_tests(root, "config_file or cell_files or declarations")
    assert p.returncode == 0, p.stdout[-3000:]
    for test in ("test_config_file[tiny-plug]", "test_cell_files[tiny-plug]"):
        assert f"PASSED benchmark/tests/test_bench_files.py::{test}" in p.stdout

    rc, out, err = tiny.run(root, "tiny-plug", seed=SEED)
    assert rc == 0, err[-3000:]
    res = tiny.result(out)
    assert res["correct"] is True and res["attempted"] > 0 and list(res["checks"]) == ["loss_gap"]
    assert set(res["metrics"]) == {"train_samples_per_s", "peak_mem_gib", "setup_s"}
    assert err.count("logged a step") >= res["attempted"]  # the task's hook, each timed step

    after = _hashes(root)
    assert {k: after[k] for k in before} == before
    # BENCHMARK.json: the old entries as they were, the new cell added to its metrics' lists
    got = json.loads((root / "BENCHMARK.json").read_text())
    assert got["configs"][:-1] == bench0["configs"] and got["workloads"][:-1] == bench0["workloads"]
    for group in ("end_to_end", "per_layer"):
        assert len(got[group]) == len(bench0[group])
        for new, old in zip(got[group], bench0[group]):
            if "workloads" in new:
                new["workloads"] = [w for w in new["workloads"] if w != "tiny-plug"]
            assert new == old


def test_a_key_the_family_does_not_declare_is_refused(tmp_path):
    """The plug-in family's block key in a uno2d configuration fails the
    schema test of that configuration alone."""
    root = tiny.build(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (root / "benchmark/reference/plug2d.py").write_text(FILES["benchmark/reference/plug2d.py"])
    _add_config(root, bench, _config("tiny-plug", "plug2d", "darcy"))
    _add_config(root, bench, _config("tiny-stray", "uno2d", "darcy"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    p = _schema_tests(root, "config_file and tiny")
    assert p.returncode != 0
    assert "FAILED benchmark/tests/test_bench_files.py::test_config_file[tiny-stray]" in p.stdout
    assert "PASSED benchmark/tests/test_bench_files.py::test_config_file[tiny-plug]" in p.stdout
