"""The port's summary, profiling and TensorBoard hooks
(``uno_tpu_torch/utils``, ``train/metrics.py``) against ``uno_tpu``'s, on
the CPU: ``count_params`` and ``param_bytes`` equal ``uno_tpu``'s on the
same models at the presets' widths; ``trace`` writes a Chrome trace that
names its ``annotate`` regions, and the program's spans under ``cli train
--profile-dir``; ``enable_nan_debugging`` stops at the first
non-finite module output; ``MetricLogger`` writes TensorBoard scalars, and
raises where ``uno_tpu``'s would drop them; ``cli train --profile-dir
--tensorboard``."""

import glob
import json
import os
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_train import _split_cache
from uno_tpu.models import build_model as jax_build_model
from uno_tpu.utils import summary as jsummary
from uno_tpu_torch import cli
from uno_tpu_torch.configs.presets import get_preset
from uno_tpu_torch.models import build_model
from uno_tpu_torch.train.metrics import MetricLogger
from uno_tpu_torch.utils import annotate, enable_nan_debugging, trace
from uno_tpu_torch.utils.summary import count_params, param_bytes, summarize


@pytest.mark.parametrize("preset,shape", [("darcy_s211", (1, 211, 211, 1)),
                                          ("darcy_s421", (1, 421, 421, 1)),
                                          ("ns3d_t40", (1, 64, 64, 10, 1))])
def test_count_params_and_bytes_equal_uno_tpus(preset, shape):
    p = get_preset(preset)
    for dtype in ("float32", "bfloat16"):
        jm = jax_build_model(p.model, dtype=dtype, **p.model_kwargs)
        tree = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros(shape, jnp.float32))
        model = build_model(p.model, dtype=dtype, generator=torch.Generator().manual_seed(0),
                            **p.model_kwargs)
        assert count_params(model) == jsummary.count_params(tree) > 0
        assert param_bytes(model) == jsummary.param_bytes(tree)
    lines = summarize(model).splitlines()
    assert len(lines) == len(list(model.parameters())) + 2
    assert lines[-1].split()[-1] == f"{count_params(model):,}"


def test_trace_writes_a_chrome_trace_naming_the_regions(tmp_path):
    d = str(tmp_path / "prof")
    with trace(None):  # no directory: nothing to do
        pass
    assert not os.path.exists(d)

    @annotate("uno_decorated")
    def f():
        return torch.ones(3).sum()

    with trace(d):
        with annotate("uno_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        f()
    with trace(d):
        f()
    files = sorted(glob.glob(os.path.join(d, "*.pt.trace.json")))
    assert len(files) == 2  # one file per capture
    with open(files[0]) as fh:
        names = {str(e.get("name")) for e in json.load(fh)["traceEvents"]}
    assert {"uno_region", "uno_decorated"} <= names
    assert any("mm" in n for n in names)


def test_nan_debugging_stops_at_the_first_non_finite_output():
    model = torch.nn.Sequential(torch.nn.Linear(3, 3), torch.nn.ReLU())
    with torch.no_grad():
        model[0].bias[0] = float("nan")
    enable_nan_debugging(True)
    try:
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="Linear"):
            model(torch.ones(2, 3))
    finally:
        enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()
    assert torch.isnan(model(torch.ones(2, 3))).any()  # the hook is gone


def test_metric_logger_writes_tensorboard_scalars(tmp_path):
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    d = str(tmp_path / "tb")
    stream = open(os.devnull, "w")
    logger = MetricLogger(stream, tensorboard_dir=d)
    logger.log({"task": "darcy", "epoch": 0, "step": 4, "train_rel_l2": 0.5, "saved": True,
                "step_ms": [1.0, 2.0]})
    logger.log({"task": "darcy", "test_rel_l2": 0.25})  # no step: not a scalar
    logger.close()
    stream.close()
    assert glob.glob(os.path.join(d, "events.out.tfevents.*"))
    acc = EventAccumulator(d)
    acc.Reload()
    tags = set(acc.Tags()["scalars"])
    assert tags == {"epoch", "train_rel_l2", "saved"}  # uno_tpu's rule: int and float fields
    (ev,) = acc.Scalars("train_rel_l2")
    assert (ev.step, ev.value) == (4, 0.5)


def test_metric_logger_raises_without_tensorboard(monkeypatch, tmp_path):
    """uno_tpu drops the writer when its import fails; the port raises."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError, match="tensorboard"):
        MetricLogger(tensorboard_dir=str(tmp_path / "tb"))
    MetricLogger()  # no directory, no import


def test_cli_train_profile_dir_and_tensorboard(tmp_path, capsys):
    pytest.importorskip("tensorboard")
    data, prof, tb = (str(tmp_path / n) for n in ("d.npz", "prof", "tb"))
    _split_cache(data)
    rc = cli.main(["train", "--preset", "darcy_s85", "--data-cache", data, "--ntrain", "2",
                   "--nval", "1", "--ntest", "1", "--epochs", "1", "--batch-size", "2",
                   "--device", "cpu", "--profile-dir", prof, "--tensorboard", tb])
    assert rc == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert lines[0]["step"] == 1
    (path,) = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    with open(path) as fh:
        text = fh.read()
    assert "aten::_fft_r2c" in text or "aten::fft_rfft2" in text
    names = {str(e.get("name")) for e in json.loads(text)["traceEvents"]}
    assert {"grad", "forward", "backward", "optimizer"} <= names  # the program's spans
    assert glob.glob(os.path.join(tb, "events.out.tfevents.*"))
