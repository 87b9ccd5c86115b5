"""The port's spans (``uno_tpu_torch/utils/profiling.py``) on the CPU: off,
``annotate`` returns a shared no-op and reads no clock, allocates nothing
and calls nothing of torch; on, a Darcy step through ``dp_value_and_grad``
and ``ComplexAdam`` records ``grad`` around ``forward`` and
``backward``, then ``optimizer``, each on the main thread with its parent; a
served forward records one ``forward``; a 3-D forward opens ``conv3d`` and
``truncate3d`` once a block and ``skip_resize`` once a skip inside it, and
``ops/spectral.py``'s ``TRANSFORMS_3D`` counts two r2c and two c2r a block
and none more in the backward, where a Darcy step opens and counts none of
them; ``export_forward`` exports with
recording on as with it off, and its tracing records nothing.  The
``allreduce`` spans are checked in ``tests/test_torch_parallel.py``, the
``trace`` bridge in ``tests/test_torch_utils.py``."""

import io
from collections import Counter
import threading
import time
import tracemalloc

import pytest
import torch

from uno_tpu_torch.export import export_forward
from uno_tpu_torch.losses import relative_lp_loss
from uno_tpu_torch.models import build_model
from uno_tpu_torch.ops import spectral
from uno_tpu_torch.optim import ComplexAdam
from uno_tpu_torch.parallel import dp_value_and_grad
from uno_tpu_torch.utils import annotate, profiling, start_recording, stop_recording

DARCY_KW = dict(in_width=3, width=8, pad=1)  # uno9 at 85x85


def _model():
    return build_model("uno9", generator=torch.Generator().manual_seed(1), **DARCY_KW)


def _batch(n=2, s=85):
    g = torch.Generator().manual_seed(2)
    return torch.randn(n, s, s, 1, generator=g), torch.randn(n, s, s, generator=g)


@pytest.fixture
def recording():
    """Recording on for the test; the spans are ``rec()``'s."""
    start_recording()
    out = []
    try:
        yield lambda: out.append(stop_recording()) or out[0]
    finally:
        if not out:
            stop_recording()


def test_off_is_a_shared_noop_with_no_clock_allocation_or_torch(monkeypatch):
    @annotate("decorated")
    def f(v):
        return v + 1

    assert annotate("grad") is annotate("grad")
    assert annotate("grad") is not annotate("optimizer")

    def forbidden(*args, **kwargs):
        raise AssertionError("called with spans off")

    for mod, name in ((time, "perf_counter_ns"), (time, "time_ns"),
                      (torch.compiler, "is_compiling"), (torch.compiler, "is_exporting"),
                      (torch.cuda, "synchronize"), (profiling, "record_function"),
                      (profiling, "_Span")):
        monkeypatch.setattr(mod, name, forbidden)
    with annotate("grad"):
        assert f(1) == 2
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with annotate("grad"):
                f(1)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grew = [d for d in after.compare_to(before, "filename")
            if d.size_diff > 0 and "profiling.py" in d.traceback[0].filename]
    assert not grew, grew
    monkeypatch.undo()

    start_recording()
    rec = stop_recording()
    assert rec.spans == [] and rec.anchor[0] > 0
    with pytest.raises(RuntimeError):
        stop_recording()


def test_a_training_step_records_grad_forward_backward_and_optimizer(recording):
    model = _model()
    opt = ComplexAdam(model.parameters(), lr=1e-3, weight_decay=1e-4)
    value_and_grad = dp_value_and_grad(
        lambda x, y: relative_lp_loss(model(x).reshape(y.shape), y, reduction="sum"), None,
        model.parameters())
    x, y = _batch()
    opt.zero_grad(set_to_none=True)
    value_and_grad(x, y)
    opt.step()
    rec = recording()
    main = threading.get_ident()
    names = [s[0] for s in rec.spans]
    assert names[:2] == ["grad", "forward"] and set(names) == {"grad", "forward", "backward",
                                                               "optimizer"}
    assert names.count("grad") == names.count("optimizer") == names.count("backward") == 1
    g, o = names.index("grad"), names.index("optimizer")
    by = {n: s for n, s in zip(names, rec.spans)}
    assert by["grad"][3] is None and by["optimizer"][3] is None
    assert by["forward"][3] == by["backward"][3] == g  # the forward of the loss, in grad
    assert all(s[4] == main for s in (by["grad"], by["backward"], by["optimizer"]))
    for s in rec.spans:
        assert s[1] <= s[2]
        if s[3] is not None and s[4] == rec.spans[s[3]][4]:
            assert rec.spans[s[3]][1] <= s[1] and s[2] <= rec.spans[s[3]][2]
    assert rec.spans[g][2] <= rec.spans[o][1]
    assert abs(rec.epoch_ns(time.perf_counter_ns()) - time.time_ns()) < 5e6


def test_an_inference_forward_records_one_forward(recording):
    model = _model().eval()
    with torch.inference_mode():
        model(_batch(1)[0])
    (span,) = recording().spans
    assert span[0] == "forward" and span[3] is None and span[4] == threading.get_ident()


@pytest.mark.parametrize("dims", [2, 3])
def test_the_3d_spans_and_transform_count_are_the_3d_paths(recording, dims):
    """uno3d_t40 at width 2 on a 48x48 grid (its factory's modes need 6 cells
    at the bottom block, 48 / 8), 10 frames, against uno9 at 85x85."""
    if dims == 3:
        model = build_model("uno3d_t40", width=2, generator=torch.Generator().manual_seed(3))
        x = torch.randn(1, 48, 48, 10, 1, generator=torch.Generator().manual_seed(4))
    else:
        model, x = _model(), _batch(1)[0]
    spectral.TRANSFORMS_3D.update(dict.fromkeys(spectral.TRANSFORMS_3D, 0))
    out = model(x)
    forward = dict(spectral.TRANSFORMS_3D)
    out.square().sum().backward()
    rec = recording()
    blocks = model.spec.blocks if dims == 3 else ()
    n, skips = len(blocks), sum(b.skip is not None for b in blocks)
    names = Counter(s[0] for s in rec.spans)
    assert names == Counter(forward=1, conv3d=n, truncate3d=n, skip_resize=skips) + Counter()
    top = [i for i, s in enumerate(rec.spans) if s[0] == "forward"]
    assert all(s[3] == top[0] for s in rec.spans if s[0] != "forward")
    assert forward == spectral.TRANSFORMS_3D == {"r2c": 2 * n, "c2r": 2 * n}


def test_export_with_recording_on_exports_as_off():
    """The program exported while recording holds no profiler node and
    serves the eager forward's output (``tests/test_torch_export.py``'s
    bound); the trace records no span."""
    model = _model().eval()
    x = _batch(1)[0]
    start_recording()
    try:
        program = torch.export.load(io.BytesIO(export_forward(model, x)))
    finally:
        rec = stop_recording()
    assert rec.spans == []
    assert "profiler" not in program.graph_module.code
    with torch.no_grad():
        want = model(x)
    got = program.module()(x).detach()
    assert float((got - want).norm() / want.norm()) <= 1e-5
