"""The reference-budget runs' tool (``tools/torch_budget_run.py``) on the
CPU: its summary of a run's records, and the committed logs of the card's
runs against their bars (darcy_s211 bf16: 700 epochs, test rel-L2 <=
0.55%; ns3d_t40 f32: 80 epochs, test full-field <= 1.10%)."""

import os
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "tools"))

import torch_budget_run as tool  # noqa: E402


def test_summarize_reads_the_step_times_the_target_and_the_test():
    records = [
        {"epoch": 0, "epoch_sec": 10.0, "val_rel_l2": 0.5, "step_ms": [900.0, 20.0]},
        {"epoch": 1, "epoch_sec": 2.0, "val_rel_l2": 0.2, "step_ms": [21.0, 23.0]},
        {"epoch": 2, "epoch_sec": 3.0, "val_rel_l2": 0.05, "step_ms": [22.0, 30.0]},
        {"epoch": 3, "epoch_sec": 4.0, "val_rel_l2": 0.04, "step_ms": [22.0, 22.5]},
        {"test_rel_l2": 0.045},
        {"val_rel_l2": 0.04, "test_rel_l2": 0.045, "checkpoint": "ck"},
    ]
    got = tool.summarize(records, "val_rel_l2", "test_rel_l2", target=0.1)
    assert got["epochs"] == 4
    assert got["median_warm_step_ms"] == pytest.approx(22.25)  # epoch 0 left out
    assert got["first_epoch_at_target"] == 2
    assert got["epoch_sec_to_target"] == pytest.approx(15.0)
    assert (got["best_val"], got["best_val_epoch"]) == (0.04, 3)
    assert got["test"] == [0.045, 0.045]
    assert got["train_sec"] == pytest.approx(19.0)
    missed = tool.summarize(records, "val_rel_l2", "test_rel_l2", target=0.01)
    assert missed["first_epoch_at_target"] is None and missed["epoch_sec_to_target"] is None


@pytest.mark.parametrize("run,epochs,steps", [("darcy_s211", 700, 94), ("ns3d_t40", 80, 128)])
def test_committed_log_meets_its_bar(run, epochs, steps):
    stem, _, _, val_key, test_key, target = tool.RUNS[run]
    records = tool._records(os.path.join(_ROOT, "runs", f"{stem}.jsonl"))
    got = tool.summarize(records, val_key, test_key, target)
    assert got["epochs"] == epochs
    assert all(len(r["step_ms"]) == steps for r in records if "epoch" in r)
    assert got["test"] and max(got["test"]) <= target
    assert got["first_epoch_at_target"] is not None
    assert "| test |" in tool.table(run, [os.path.join(_ROOT, "runs", f"{stem}.jsonl")])
