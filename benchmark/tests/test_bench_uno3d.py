"""The ``uno3d`` family and the ``ns3d`` task on the CPU: the plain reference
against the program at width 4 in float32 (the forward, the summed relative
L2, every gradient, two Adam steps); the program's 3-D transform counter
against ``uno3d_counts``' transforms; the counts by hand; the TF32 rounding
of the control; the spec check; and the tiny ns3d cell (``tiny3d.py``) run
through ``benchmark.run``: correct, while the TF32 control, an unchanged
state and half the batch are not, and with the program's spans recorded,
the 3-D span readers read them."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from collections import Counter
from types import SimpleNamespace

import pytest
import torch

from benchmark import common, counts, inputs
from benchmark.reference import uno3d, uno3d_counts
from benchmark.run import load_module
from benchmark.tests import tiny, tiny3d

SEED = 2**31 + 41
# float32 on both sides, the same operations in another order: rounding
F32 = 1e-5
# a gradient, through seven blocks of FFTs: the readings lie near 2e-6
GRAD = 1e-4


def _rel(a, b):
    return float((a - b).detach().norm() / b.detach().norm())


def _pair(seed, width=4):
    cfg = tiny3d.tiny_config(width)
    w = inputs.weights(cfg, seed, "cpu")
    return cfg, w, common.program_model(cfg, w, torch.device("cpu"))


def test_forward_loss_and_gradients():
    from uno_tpu_torch.losses import relative_lp_loss
    from uno_tpu_torch.train.ns3d import forecast

    cfg, w, model = _pair(5)
    x, y = inputs.train_split(cfg, inputs.generator(5, "train", "cpu"), 2, "cpu")
    out = forecast(model, x, cfg["t_f"])
    ref_p = {k: v.clone().requires_grad_() for k, v in w.items()}
    ref = uno3d.forward(cfg["model"], ref_p, x[..., None])
    assert ref.shape == (2, 64, 64, 40, 1) and _rel(out, ref.reshape(out.shape)) < F32
    loss = relative_lp_loss(out, y, reduction="sum")
    ref_loss = uno3d.rel_l2_sum(ref.reshape(y.shape), y)
    assert abs(float(loss) - float(ref_loss)) < F32 * float(ref_loss)
    loss.backward()
    ref_loss.backward()
    norms = {n: float(ref_p[n].grad.norm()) for n in ref_p}
    med = sorted(norms.values())[len(norms) // 2]
    for n, p in model.named_parameters():
        # a bias just before an instance norm has a gradient of rounding noise
        if norms[n] > 1e-3 * med:
            assert _rel(p.grad, ref_p[n].grad) < GRAD, n
        else:
            assert n.endswith(".w.bias") and model.spec.blocks[int(n[5])].normalize, n


def test_two_adam_steps_equal_complex_adam():
    from uno_tpu_torch.optim import ComplexAdam

    cfg, w, model = _pair(6, width=2)
    o = cfg["optimizer"]
    opt = ComplexAdam(model.parameters(), lr=o["lr"], weight_decay=o["weight_decay"])
    ref_p = {k: v.clone() for k, v in w.items()}
    adam = uno3d.Adam(ref_p, lambda n: o["lr"], o["weight_decay"])
    g = torch.Generator().manual_seed(7)
    for _ in range(2):
        grads = {n: torch.randn(p.shape, dtype=p.dtype, generator=g)
                 for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = grads[n].clone()
        opt.step()
        adam.step(grads)
    for n, p in model.named_parameters():
        assert _rel(p.detach(), ref_p[n]) < 1e-6, n


def test_the_transform_counter_equals_the_count():
    """After one forward, and after one training step, the program's 3-D
    transforms by kind are those ``uno3d_counts.transforms`` counts, less the
    backward's (autograd's, which the program does not count)."""
    from uno_tpu_torch.losses import relative_lp_loss
    from uno_tpu_torch.ops import spectral
    from uno_tpu_torch.train.ns3d import forecast

    cfg, _, model = _pair(8, width=2)
    x, y = inputs.train_split(cfg, inputs.generator(8, "train", "cpu"), 1, "cpu")
    for kind in ("serve", "train"):
        spectral.TRANSFORMS_3D.update(dict.fromkeys(spectral.TRANSFORMS_3D, 0))
        out = forecast(model, x, cfg["t_f"])
        if kind == "train":
            relative_lp_loss(out, y, reduction="sum").backward()
        counted = Counter(k for k, _, _ in uno3d_counts.transforms(cfg, 1, kind))
        assert spectral.TRANSFORMS_3D == {k: counted[k] for k in ("r2c", "c2r")}, kind
        assert counted["r2c_backward"] + counted["c2r_backward"] == (
            0 if kind == "serve" else 4 * len(cfg["model"]["blocks"]))


CFG = json.loads((tiny.ROOT / "benchmark/configs/ns3d_t40-uno3d-f32.json").read_text())


def test_counts_of_the_configuration():
    """The blocks' grids and channels from the preset's shapes (time 13 ->
    52, cropped to 40), the contractions' modes, and the transforms' bytes
    and bound by hand."""
    ks = uno3d_counts.blocks(CFG)
    assert [k["h"] for k in ks] == [(64, 64, 13), (48, 48, 13), (32, 32, 13), (16, 16, 20),
                                    (8, 8, 20), (32, 32, 31), (48, 48, 41)]
    assert ks[-1]["d"] == (64, 64, 52) and 52 - 4 * 3 == CFG["t_f"]
    assert [(k["ci"], k["co"]) for k in ks] == [(8, 16), (16, 32), (32, 64), (64, 128),
                                                (128, 32), (64, 16), (32, 16)]
    shapes = uno3d_counts.contract_shapes(CFG, 16)
    assert [m for *_, m in shapes] == [6400, 3136, 576, 1008, 1008, 7840, 22400]
    params = sum(ci * co * m for _, ci, co, m in shapes)
    assert params == 35_487_744  # the spectral weights' complex entries
    serve = uno3d_counts.transforms(CFG, 16, "serve")
    train = uno3d_counts.transforms(CFG, 16, "train")
    assert len(serve) == 28 and len(train) == 56
    assert serve[:4] == [("r2c", 128, (64, 64, 13)), ("c2r", 256, (48, 48, 13)),
                         ("r2c", 128, (64, 64, 13)), ("c2r", 128, (48, 48, 13))]
    assert uno3d_counts.transform_bytes(128, (64, 64, 13)) == 128 * (4 * 64 * 64 * 13
                                                                    + 8 * 64 * 64 * 7)
    peak = counts.PEAKS["H100"]
    b = counts.bounds(dict(CFG, reference="uno3d"), 16, "train", peak)
    one = counts.bounds(dict(CFG, reference="uno3d"), 16, "serve", peak)
    assert b["fft_s"] == pytest.approx(2 * one["fft_s"]) and set(b) == {"contract_s", "fft_s"}
    assert b["contract_s"] == pytest.approx(3 * one["contract_s"])
    nbytes = sum(uno3d_counts.transform_bytes(n, g) for _, n, g in train)
    assert b["fft_s"] == pytest.approx(nbytes / peak["hbm_bytes"])  # memory-bound throughout
    assert counts.step_flops(dict(CFG, reference="uno3d"), 16, "train") == pytest.approx(
        3 * counts.step_flops(dict(CFG, reference="uno3d"), 16, "serve"))


def test_tf32_rounding_keeps_ten_mantissa_bits_to_nearest():
    one = 1.0 + 2.0**-10
    x = torch.tensor([1.0 + 2.0**-12, 1.0 + 2.0**-11, -(1.0 + 2.0**-11), one + 2.0**-12, 3.0])
    got = uno3d.fp8_round(x)
    assert got.tolist() == [1.0, one, -one, one, 3.0]
    z = torch.complex(x, -x)
    assert torch.equal(uno3d.fp8_round(z), torch.complex(got, -got))
    v = torch.randn(1000)
    r = uno3d.fp8_round(v)
    assert float(((r - v) / v).abs().max()) <= 2.0**-11
    assert uno3d.fp8_round.where == "operands" and uno3d.bf16_round.where == "policy"
    v.requires_grad_()
    uno3d.fp8_round(v).sum().backward()
    assert torch.equal(v.grad, torch.ones(1000))  # straight through


def test_check_spec_refuses_another_time_factor_or_crop():
    from uno_tpu_torch.models import build_model

    spec = build_model("uno3d_t40", width=2, pad=3).spec
    model = tiny3d.tiny_config(2)["model"]
    uno3d.check_spec(spec, model)
    for key, value in (("crop_mult", "2"), ("pad", 2)):
        with pytest.raises(ValueError):
            uno3d.check_spec(spec, dict(model, **{key: value}))
    blocks = [dict(b) for b in model["blocks"]]
    blocks[4]["time"] = "2"
    with pytest.raises(ValueError):
        uno3d.check_spec(spec, dict(model, blocks=blocks))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny3d.build(tmp_path_factory.mktemp("bench3d"))


def test_the_tiny_cell_is_correct(tree):
    rc, out, err = tiny.run(tree, tiny3d.CELL, seed=SEED)
    assert rc == 0, err[-3000:]
    res = tiny.result(out)
    assert res["correct"] is True and res["attempted"] > 0, res["checks"]
    assert set(res["metrics"]) == {"train_samples_per_s", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("mode", ["control", "fault:unchanged", "fault:half_batch"])
def test_the_control_and_faults_are_not_correct(tree, mode):
    rc, out, err = tiny.run(tree, tiny3d.CELL, "--calibrate", "11,12", "--mode", mode,
                            seed=SEED)
    assert rc == 0, err[-3000:]
    rows = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert [r["correct"] for r in rows] == [False, False], rows


# ``benchmark.run`` with ``SpanCapture`` in place of ``trace.Capture``: the
# spans counted, and each 3-D reader's value on the traced steps (on the CPU
# nothing is busy, so the reading claims the window)
SWAPPED = """
import json, sys
from collections import Counter
from types import SimpleNamespace
from benchmark import run, spans, trace

class Counted(spans.SpanCapture):
    def trace(self):
        tr = super().trace()
        print("spans:", json.dumps(Counter(s[0] for s in tr.spans)), file=sys.stderr)
        r = SimpleNamespace(trace=tr, busy_s=tr.window_s)
        for name in ("conv3d_host_ms.train", "truncate3d_host_ms.train"):
            read = run.load_module(run.ROOT / "benchmark" / "metrics" / f"{name}.py").read
            print("reader:", name, read(r), file=sys.stderr)
        return tr

trace.Capture = Counted
sys.exit(run.main(sys.argv[1:]))
"""


def test_the_3d_span_readers_read_a_span_capture_of_the_tiny_cell(tree):
    p = subprocess.run([sys.executable, "-c", SWAPPED, "--workload", tiny3d.CELL, "--seed",
                        str(SEED + 1), "--seconds", "1", "--trace", "1", "--device", "cpu",
                        "--root", str(tree)], cwd=tree, capture_output=True, text=True,
                       timeout=900, env={**os.environ, "PYTHONPATH": str(tiny.ROOT),
                                         "OMP_NUM_THREADS": "2"})
    assert p.returncode == 0, p.stderr[-3000:]
    assert tiny.result(p.stdout)["correct"] is True
    (line,) = [s for s in p.stderr.splitlines() if s.startswith("spans: ")]
    steps = tiny3d.TRAIN["trace_steps"]
    blocks = tiny3d.tiny_config()["model"]["blocks"]
    skips = sum(b.get("skip") is not None for b in blocks)
    assert json.loads(line[len("spans: "):]) == {
        "grad": steps, "forward": steps, "backward": steps, "optimizer": steps,
        "conv3d": steps * len(blocks), "truncate3d": steps * len(blocks),
        "skip_resize": steps * skips}
    read = {s.split()[1]: float(s.split()[2]) for s in p.stderr.splitlines()
            if s.startswith("reader: ")}
    assert set(read) == {"conv3d_host_ms.train", "truncate3d_host_ms.train"}
    assert all(v > 0 and math.isfinite(v) for v in read.values()), read


@pytest.mark.parametrize("name", ["fft_roofline.train", "conv3d_host_ms.train",
                                  "truncate3d_host_ms.train"])
def test_the_new_readers_find_nothing_in_a_bare_trace(name):
    """The parent's program has no 3-D spans, and a trace with no transform
    kernel has nothing to read: each reader returns None."""
    from benchmark import trace

    read = load_module(tiny.ROOT / "benchmark" / "metrics" / f"{name}.py").read
    r = SimpleNamespace(trace=trace.Trace(device=[("k", 0.0, 1.0)], window_s=2.0, steps=1),
                        busy_s=1.0, cfg=dict(CFG, reference="uno3d"), batch=16, chips=1,
                        kind="train", peak=counts.PEAKS["H100"])
    assert read(r) is None
    if name == "fft_roofline.train":
        r.trace.device.append(("regular_fft_factor", 1.0, 1.1))
        want = 100.0 * counts.bounds(r.cfg, 16, "train", r.peak)["fft_s"] / 0.1
        assert read(r) == pytest.approx(want)
