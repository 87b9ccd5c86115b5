"""The benchmark's cells on the card, short: each prints a correct result
line with its metrics (``python -m pytest benchmark/tests -m cuda`` on a
machine with an H100; skips elsewhere)."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_the_card(cell):
    import torch

    chips = next(w["chips"] for w in BENCH["workloads"] if w["name"] == cell)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA device(s)")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed",
                        str(2**31 + 3), "--seconds", "3", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == chips
