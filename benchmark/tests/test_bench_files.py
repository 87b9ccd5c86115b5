"""BENCHMARK.json and every file it names: the contract's keys, names and
limits, and each configuration, cell, traffic mix and metric file holding
only keys the harness reads: a configuration the keys its model family
declares (``benchmark/plugins.py``), a traffic mix and a cell's limits the
keys their driver declares."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from benchmark import common, inputs, plugins
from benchmark.run import load_module

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _driver(name: str):
    return load_module(ROOT / "benchmark" / "traffic" / f"{name}.py")


def test_declarations_hold_the_keys_the_harness_reads():
    """The uno2d family's and the two drivers' declared keys."""
    fam = plugins.family({"reference": "uno2d"})
    assert common.CONFIG_KEYS | fam.CONFIG_KEYS == {
        "name", "source", "about", "reduced", "assumed", "task", "reference", "grid", "program",
        "model", "optimizer", "data", "t_in", "t_f"}
    assert fam.MODEL_KEYS == {"in_width", "width", "lift_hidden", "embed", "pad", "pad_mode",
                              "darcy_base", "blocks", "proj_hidden", "proj_concat_lift",
                              "out_dim", "precision"}
    assert fam.BLOCK_KEYS == {"channels", "grid", "modes", "normalize", "residual", "skip"}
    train, serve = _driver("train_step"), _driver("serve_batch")
    assert train.TRAFFIC_KEYS == {"driver", "batch", "compared_steps", "warm_steps",
                                  "timing_steps", "trace_skip", "trace_steps"}
    assert serve.TRAFFIC_KEYS == {"driver", "batch", "pool_batches", "warm_batches",
                                  "sample_batches", "trace_skip", "trace_batches"}
    assert train.LIMIT_KEYS == {"loss_gap", "grad_gap", "change_gap", "change_median_gap"}
    assert serve.LIMIT_KEYS == {"answer_gap"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32 and not any(w.startswith("/") for w in BENCH["command"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_entry_keys():
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"})):
        for e in BENCH[group]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]) and e["name"] not in names
            names.add(e["name"])
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(e["name"]) and UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                                                  "higher")
    for e in BENCH["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert e["source"] in ("host_clock", "device_trace") and 0.01 <= e["bound"] <= 0.25
    for e in BENCH["per_layer"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert e["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_each_cell_reports_setup_another_metric_and_a_layer():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"]) and len(four) <= 1
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        reported = {n for n, m in e2e.items() if cell in m.get("workloads", cells)}
        assert "setup_s" in reported and len(reported) >= 2
        layers = [m for m in BENCH["per_layer"] if cell in m.get("workloads", cells)]
        assert layers and all(m["moves"] in reported for m in layers)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    cfg = json.loads((ROOT / entry["file"]).read_text())
    fam = plugins.family(cfg)
    assert set(cfg) <= common.CONFIG_KEYS | fam.CONFIG_KEYS and cfg["name"] == entry["name"]
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"] == []
    assert set(cfg["model"]) == fam.MODEL_KEYS
    assert all(set(b) <= fam.BLOCK_KEYS for b in cfg["model"]["blocks"])
    plugins.task(cfg)  # the task's module is there
    # the program builds the architecture the file states, and takes its weights
    from uno_tpu_torch.models import build_model

    prog = cfg["program"]
    spec = build_model(prog["model"], dtype=prog["dtype"], **prog["kwargs"]).spec
    fam.check_spec(spec, cfg["model"])


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_files(entry):
    traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{entry['traffic']}.json")
                         .read_text())
    driver = _driver(traffic["driver"])
    assert set(traffic) == driver.TRAFFIC_KEYS
    cell = json.loads((ROOT / "benchmark" / "workloads" / f"{entry['name']}.json").read_text())
    assert set(cell) == {"limits"} and set(cell["limits"]) == driver.LIMIT_KEYS
    assert all(v > 0 for v in cell["limits"].values())


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_exists(metric):
    mod = load_module(ROOT / "benchmark" / "metrics" / f"{metric['name']}.py")
    assert callable(mod.read)


def test_weights_are_the_seeds():
    """The same seed gives the same weights and inputs, another seed others;
    a seed past 32 bits is taken."""
    cfg = json.loads((ROOT / "benchmark/configs/darcy_s211-uno9-bf16.json").read_text())
    cfg = dict(cfg, grid=32)
    seed = 2**31 + 12345
    a = inputs.weights(cfg, seed, "cpu")
    b = inputs.weights(cfg, seed, "cpu")
    c = inputs.weights(cfg, seed + 1, "cpu")
    assert all(a[k].equal(b[k]) for k in a) and not a["fc.weight"].equal(c["fc.weight"])
    x1, y1 = inputs.train_split(cfg, inputs.generator(seed, "train", "cpu"), 3, "cpu")
    x2, _ = inputs.train_split(cfg, inputs.generator(seed, "train", "cpu"), 3, "cpu")
    assert x1.equal(x2) and set(x1.unique().tolist()) == {3.0, 12.0}
    assert x1.shape == (3, 32, 32, 1) and y1.shape == (3, 32, 32)
