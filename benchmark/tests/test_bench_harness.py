"""The harness end to end on the CPU, on tiny cells added as new files:
runs come out correct; the control (the reference rounded to float8 in the
program's place) and each fault a cell can have come out not correct; a
new cell and a new metric are picked up by name; a run without a card, or
in a directory holding only the benchmark's files, prints no result.

Each run is a process of its own (``--device cpu`` skips the look for a
card).  ``seed`` is past 32 bits, as the driver's are."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from benchmark.tests import tiny

SEED = 2**31 + 11
DUMMY = '''"""The traced window's wall time a step, in ms (a test's metric)."""


def read(r):
    return 1e3 * r.trace.window_s / r.trace.steps
'''


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tiny.build(tmp_path_factory.mktemp("bench"))
    # a new metric, as a later PR adds one: its file and its entry
    (root / "benchmark" / "metrics" / "dummy_ms.train.py").write_text(DUMMY)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "dummy_ms.train", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "test",
                               "moves": "train_samples_per_s", "workloads": ["tiny-train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _ok(rc, out, err):
    assert rc == 0, err[-3000:]
    return tiny.result(out)


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-dp2-train", "tiny-serve",
                                  "tiny-rollout"])
def test_runs_are_correct(tree, cell):
    res = _ok(*tiny.run(tree, cell, seed=SEED))
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    metric = "train_samples_per_s" if "train" in cell else "serve_samples_per_s"
    assert set(res["metrics"]) == {metric, "peak_mem_gib", "setup_s"}
    assert res["device"]["count"] == (2 if "dp2" in cell else 1)


def test_trace_run_picks_up_a_new_metric(tree):
    res = _ok(*tiny.run(tree, "tiny-train", seed=SEED + 1, trace=1))
    # on the CPU nothing runs on a device: only the test's metric reads
    assert list(res["metrics"]) == ["dummy_ms.train"] and res["metrics"]["dummy_ms.train"][
        "value"] > 0
    assert res["device"]["window_s"] > 0 and "breakdown" in res


@pytest.mark.parametrize("cell,fault", [("tiny-train", "unchanged"),
                                        ("tiny-train", "half_batch"),
                                        ("tiny-dp2-train", "no_exchange"),
                                        ("tiny-serve", "altered_answer"),
                                        ("tiny-rollout", "altered_answer")])
def test_faults_are_not_correct(tree, cell, fault):
    res = _ok(*tiny.run(tree, cell, "--mode", f"fault:{fault}", seed=SEED))
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-serve", "tiny-rollout"])
def test_control_is_not_correct(tree, cell):
    """On three seeds the float8 control fails a number that the program
    passes on the same seeds."""
    rc, out, err = tiny.run(tree, cell, "--calibrate", "11,12,13", "--mode",
                            "program,control", seed=SEED)
    assert rc == 0, err[-3000:]
    rows = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert [r["correct"] for r in rows] == [True] * 3 + [False] * 3, rows


def test_no_card_no_result(tree):
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "tiny-serve",
                        "--seed", "1", "--seconds", "1", "--trace", "0", "--root", str(tree)],
                       cwd=tree, capture_output=True, text=True, timeout=300,
                       env={"PYTHONPATH": str(tiny.ROOT), "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copytree(tiny.ROOT / "benchmark", tmp_path / "benchmark")
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "darcy_s211-serve-b16", "--seed", "1", "--seconds", "1", "--trace", "0",
                        "--device", "cpu"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
