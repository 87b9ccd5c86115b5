"""The ``uno2d`` family's counts (``reference/uno2d_counts.py``, read
through ``counts.py``) against the arithmetic of ``chip_smoke.py`` (its
``_bound``, the contraction's and the head's bytes and flops) at
darcy_s211's and ns2d's shapes, and the step's flop count against a sum
written out by hand for one block."""

from __future__ import annotations

import json
import math
from pathlib import Path

import pytest

from benchmark import counts
from benchmark.reference import uno2d_counts

ROOT = Path(__file__).resolve().parents[2]
PEAK = counts.PEAKS["H100"]
DARCY = json.loads((ROOT / "benchmark/configs/darcy_s211-uno9-bf16.json").read_text())
NS2D = json.loads((ROOT / "benchmark/configs/ns2d-uno-bf16.json").read_text())

# chip_smoke.py: CMUL_SHAPES, HEAD_SHAPE, NS_CMUL_SHAPES, NS_HEAD_SHAPE
SMOKE = {"darcy": ([(16, 32, 64, 648), (16, 64, 128, 128), (16, 128, 128, 128),
                    (16, 128, 64, 128), (16, 128, 32, 648)], (16, 64, 211 * 211, 32, 1)),
         "ns2d": ([(16, 32, 48, 968), (16, 48, 96, 392), (16, 96, 192, 72), (16, 192, 192, 72),
                   (16, 192, 96, 72), (16, 192, 48, 392), (16, 96, 32, 968)],
                  (16, 64, 64 * 64, 128, 1))}


def _smoke_bound(nbytes, flops):
    """chip_smoke.py ``_bound``, in seconds."""
    return max(nbytes / 3.35e9, flops / 67e9) / 1e3


@pytest.mark.parametrize("name,cfg", [("darcy", DARCY), ("ns2d", NS2D)])
def test_shapes_and_bounds_equal_chip_smoke(name, cfg):
    cmul, head = SMOKE[name]
    assert uno2d_counts.contract_shapes(cfg["model"], cfg["grid"], 16) == cmul
    assert uno2d_counts.head_shape(cfg["model"], cfg["grid"], 16) == head
    for b, ci, co, m in cmul:
        nbytes = 8 * (b * ci * m + ci * co * m + b * co * m)  # x, w, out; dx and dw alike
        want = _smoke_bound(nbytes, 8.0 * (b * co * m) * ci)
        assert uno2d_counts.contract_bound_s((b, ci, co, m), PEAK) == pytest.approx(want,
                                                                                   rel=1e-12)
    b, c, n, h, o = head
    wbytes = 4 * (c * h + h + h * o + o)
    fwd = _smoke_bound(2 * b * c * n + wbytes + 4 * b * o * n, 2.0 * b * n * (c * h + h * o))
    bwd = _smoke_bound(4 * b * c * n + 4 * b * o * n + wbytes - 4 * o + wbytes,
                       2.0 * b * n * (3 * c * h + 2 * h * o))
    assert uno2d_counts.head_bounds_s(head, PEAK) == pytest.approx((fwd, bwd), rel=1e-12)


def test_bounds_per_step_and_batch():
    """Training counts a forward and both gradients of each contraction and
    the head's forward and backward; a rollout counts t_f forwards."""
    shapes, head = SMOKE["darcy"]
    one = sum(uno2d_counts.contract_bound_s(s, PEAK) for s in shapes)
    fwd, bwd = uno2d_counts.head_bounds_s(head, PEAK)
    assert counts.bounds(DARCY, 16, "train", PEAK) == pytest.approx(
        {"contract_s": 3 * one, "head_s": fwd + bwd})
    shapes, head = SMOKE["ns2d"]
    one = sum(uno2d_counts.contract_bound_s(s, PEAK) for s in shapes)
    fwd, _ = uno2d_counts.head_bounds_s(head, PEAK)
    assert counts.bounds(NS2D, 16, "serve", PEAK) == pytest.approx(
        {"contract_s": 40 * one, "head_s": 40 * fwd})


def test_forward_flops_by_hand():
    """One block, no padding, no resample: lift, FFTs, contraction, 1x1
    conv, norm, head."""
    model = {"in_width": 3, "width": 4, "lift_hidden": 2, "pad": 0, "pad_mode": "sym",
             "blocks": [{"channels": 4, "grid": "1", "modes": [3, 3], "normalize": True,
                         "skip": "lift"}],
             "proj_hidden": 5, "out_dim": 1}
    b, s = 2, 8
    n = s * s
    want = (2.0 * b * n * (3 * 2 + 2 * 4)
            + 2 * 2.5 * b * 4 * n * math.log2(n) + 8.0 * b * 4 * 4 * 18
            + 2.0 * b * 4 * 4 * n + 8.0 * b * 4 * n
            + 2.0 * b * n * (8 * 5 + 5 * 1))
    assert uno2d_counts.forward_flops(model, s, b) == pytest.approx(want)
    cfg = {"reference": "uno2d", "grid": s, "model": model}
    assert counts.step_flops(cfg, b, "train") == pytest.approx(3 * (want + 4.0 * b * n))
