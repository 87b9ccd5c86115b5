"""The program's spans read on the device trace's clock (``benchmark/spans.py``):
the readers' arithmetic and each reader on a trace built by hand, the gaps'
names, a tiny cell run with the spans recorded (CPU), and on the card, a
kernel inside the span that launched and waited for it on the one clock."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

from benchmark import spans, trace
from benchmark.run import load_module
from benchmark.tests import tiny

DEVICE = [("k1", 0.0, 1.0), ("k2", 2.0, 3.0), ("k3", 2.5, 4.0), ("k4", 6.0, 7.0),
          ("k5", 7.9, 7.95)]
SPANS = [("grad", 0.5, 4.5, True), ("forward", 0.6, 1.5, False),
         ("backward", 1.5, 4.4, False), ("allreduce", 4.4, 4.45, False),
         ("optimizer", 5.0, 6.5, True), ("forward", 7.2, 7.6, True)]


def _reading(tr):
    return SimpleNamespace(trace=tr, busy_s=tr.busy_s())


def _hand_built():
    return spans.SpanTrace(device=list(DEVICE), window_s=8.5, steps=2, spans=list(SPANS),
                           window=(-0.5, 8.0))


def test_host_ms_and_idle_split_by_hand():
    r = _reading(_hand_built())
    # ms a step: the spans' seconds x 1e3 / 2 steps
    assert spans.host_ms(r, "forward") == pytest.approx((0.9 + 0.4) * 500)
    assert spans.host_ms(r, "backward") == pytest.approx(2.9 * 500)
    assert spans.host_ms(r, "optimizer") == pytest.approx(1.5 * 500)
    assert spans.host_ms(r, "not_a_span") is None
    # idle: [-0.5, 0] [1, 2] [4, 6] [7, 7.9] [7.95, 8]; held by grad [0.5, 4.5],
    # optimizer [5, 6.5] and the top forward [7.2, 7.6]: 1 + 0.5 + 1 + 0.4
    program, caller = spans.idle_split(r)
    assert program == pytest.approx(2.9 * 500) and caller == pytest.approx(1.55 * 500)
    assert program + caller == pytest.approx(1e3 * (8.5 - r.busy_s) / 2)


READERS = {"forward_host_ms.train": 650.0, "forward_host_ms.serve": 650.0,
           "backward_host_ms.train": 1450.0, "optimizer_host_ms.train": 750.0,
           "idle_program_ms.train": 1450.0, "idle_program_ms.serve": 1450.0,
           "idle_caller_ms.train": 775.0, "idle_caller_ms.serve": 775.0}


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader_reads_the_hand_built_trace(name):
    read = load_module(tiny.ROOT / "benchmark" / "metrics" / f"{name}.py").read
    assert read(_reading(_hand_built())) == pytest.approx(READERS[name])
    assert read(_reading(trace.Trace(device=list(DEVICE), window_s=8.5, steps=2))) is None


def test_nothing_to_read_is_none():
    bare = trace.Trace(device=list(DEVICE), window_s=8.5, steps=2)  # no spans: the parent
    for r in (_reading(bare), SimpleNamespace(trace=_hand_built(), busy_s=0.0)):
        assert spans.host_ms(r, "forward") is None and spans.idle_split(r) is None


def test_gap_names_lead_with_the_host_state_and_keep_their_lengths():
    got = _hand_built().idle_gaps()
    plain = trace.Trace(device=list(DEVICE)).idle_gaps()
    assert [g[0] for g in got] == ["in grad before k4", "in grad before k2",
                                   "in caller before k5"]
    assert [[n.split(" ", 2)[2], t] for n, t in got] == plain
    # gaps of one length, told apart by when they opened
    even = spans.SpanTrace(device=[("a", 0.0, 1.0), ("b", 2.0, 3.0), ("c", 4.0, 5.0)],
                           spans=[("optimizer", 3.0, 4.0, True)])
    assert even.idle_gaps() == [["in caller before b", 1.0], ["in optimizer before c", 1.0]]


# ``benchmark.run`` with ``trace.Capture`` swapped for ``SpanCapture``,
# the spans it read on the main thread counted on standard error
SWAPPED = """
import json, sys
from collections import Counter
from benchmark import run, spans, trace

class Counted(spans.SpanCapture):
    def trace(self):
        tr = super().trace()
        print("spans:", json.dumps(Counter(s[0] for s in tr.spans)), file=sys.stderr)
        return tr

trace.Capture = Counted
sys.exit(run.main(sys.argv[1:]))
"""


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.build(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell,names", [
    ("tiny-train", {"grad": 2, "forward": 2, "backward": 2, "optimizer": 2}),
    ("tiny-serve", {"forward": 2})])
def test_a_tiny_cell_with_the_spans_is_correct(tree, cell, names):
    p = subprocess.run([sys.executable, "-c", SWAPPED, "--workload", cell, "--seed",
                        str(2**31 + 17), "--seconds", "1", "--trace", "1", "--device", "cpu",
                        "--root", str(tree)], cwd=tree, capture_output=True, text=True,
                       timeout=600, env={**os.environ, "PYTHONPATH": str(tiny.ROOT),
                                         "OMP_NUM_THREADS": "2"})
    assert p.returncode == 0, p.stderr[-3000:]
    res = tiny.result(p.stdout)
    assert res["correct"] is True and res["metrics"] == {}  # no device: nothing to read
    (line,) = [s for s in p.stderr.splitlines() if s.startswith("spans: ")]
    assert json.loads(line[len("spans: "):]) == names


@pytest.mark.cuda
def test_a_kernel_lies_inside_its_span_on_the_trace_clock():
    """A sleep kernel of ~0.75 ms, launched and waited for inside a span, starts
    no earlier and ends no later than the span, within 50 us, once the
    recording's anchor and the trace's base time put both on one clock."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from uno_tpu_torch.utils import annotate

    device = torch.device("cuda")
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    cap = spans.SpanCapture(device)
    cap.start()
    for _ in range(8):
        torch.cuda.synchronize()
        with annotate("sleep"):
            torch.cuda._sleep(1_500_000)
            torch.cuda.synchronize()
    cap.stop()
    cap.steps = 8
    tr = cap.trace()
    kernels = sorted((a, b) for n, a, b in tr.device if "spin" in n or "sleep" in n)
    held = sorted((a, b) for n, a, b, _ in tr.spans if n == "sleep")
    assert len(kernels) == len(held) == 8
    slack = [(k[0] - s[0], s[1] - k[1]) for k, s in zip(kernels, held)]
    print(json.dumps({"kernel_ms": [1e3 * (b - a) for a, b in kernels],
                      "lead_us": [1e6 * x for x, _ in slack],
                      "trail_us": [1e6 * y for _, y in slack]}))
    assert all(b - a > 5e-4 for a, b in kernels)
    assert all(x >= -50e-6 and y >= -50e-6 for x, y in slack), slack
    assert tr.window[0] <= held[0][0] and held[-1][1] <= tr.window[1]
