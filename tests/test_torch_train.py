"""The port's training slice against uno_tpu: loss, gradients through the
whole uno9 model, the Darcy trainer and ``cli train``.

The same numpy data and one flax init (through uno_tpu_torch.bridge) go
through both packages on the CPU.  Torch's gradient of a complex weight is
the conjugate of ``jax.grad``'s, so complex leaves are compared conjugated.
Bounds:
* loss: rel 1e-6 standalone, 1e-5 through the f32 model; gradients rel-L2
  <= 1e-4 per leaf at f32 (FFT and summation orders differ).  The 1x1-conv
  bias of a block with instance norm has a gradient of zero by construction
  (the norm removes a per-channel constant); both sides leave rounding noise
  there, held under 1e-6 of the whole gradient's norm instead;
* bf16 policy with the fused head on both sides: each leaf's gradient is no
  further from uno_tpu's f32 gradient than 2x uno_tpu's own bf16 error +
  0.02 (the ratio test of tests/test_fused_head.py: both are bf16
  approximations of one f32 function);
* trainer: each epoch's train and val rel-L2 within rel 1e-3 of
  uno_tpu.train.train_darcy's, final params rel-L2 <= 1e-3 per leaf.
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uno_tpu.losses import relative_lp_loss as j_relative_lp_loss
from uno_tpu.models import build_model as jax_build_model
from uno_tpu.ops.pallas.mlp_head import set_fused_head_mode
from uno_tpu.train import MetricLogger as JMetricLogger
from uno_tpu.train import TrainConfig as JTrainConfig
from uno_tpu.train import train_darcy as j_train_darcy
from uno_tpu_torch import bridge, cli
from uno_tpu_torch.losses import relative_lp_loss
from uno_tpu_torch.models import build_model
from uno_tpu_torch.train.common import TrainConfig
from uno_tpu_torch.train.darcy import train_darcy
from uno_tpu_torch.train.metrics import MetricLogger

KW = dict(in_width=3, width=8, pad=1)
RECORD_KEYS = {"t", "task", "epoch", "step", "lr", "train_rel_l2", "val_rel_l2",
               "epoch_sec", "samples_per_sec", "saved"}


def _rel(a, b):
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _darcy_data(n, s, seed=0):
    """tests/test_train.py's learnable smooth target: a local average."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, s, s, 1)).astype(np.float32)
    y = (x[..., 0] + np.roll(x[..., 0], 1, 1) + np.roll(x[..., 0], 1, 2)) / 3.0
    return x, y.astype(np.float32)


class _Records(MetricLogger):
    def __init__(self):
        self.records = []

    def log(self, record):
        self.records.append(record)


class _JRecords(JMetricLogger):
    def __init__(self):
        self.records = []

    def log(self, record):
        self.records.append(record)


def _flat_tree(tree):
    """{flax path without 'params': numpy array}."""
    tree = tree["params"] if "params" in tree else tree
    return {tuple(k.key for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_leaves_with_path(tree)}


def _port_grads(model):
    """The port's gradients keyed like _flat_tree, in flax's layout."""
    out = {}
    for name, p in model.named_parameters():
        path, transpose = bridge._flax_path(name)
        g = p.grad.detach().float().numpy() if not p.is_complex() else p.grad.detach().numpy()
        out[path] = g.T if transpose else g
    return out


def _port_model(tree, dtype=None):
    model = build_model("uno9", dtype=dtype, generator=torch.Generator().manual_seed(1), **KW)
    return bridge.params_from_flax(model, tree)


@pytest.mark.parametrize("p", [2, 3])
@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
def test_relative_lp_loss_matches_uno_tpu(p, reduction):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 7)).astype(np.float32)
    y = rng.standard_normal((3, 5, 7)).astype(np.float32)
    want = np.asarray(j_relative_lp_loss(jnp.asarray(x), jnp.asarray(y), p, reduction))
    got = relative_lp_loss(torch.from_numpy(x), torch.from_numpy(y), p, reduction)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # bf16 inputs are widened to f32 before the norms
    got16 = relative_lp_loss(torch.from_numpy(x).bfloat16(), torch.from_numpy(y), p, reduction)
    assert got16.dtype == torch.float32


def _grads_both(dtype, fused, seed=0):
    """(port loss, port grads, uno_tpu loss, uno_tpu grads, flax tree) of
    the training loss on one batch of 2 at 85x85."""
    x, y = _darcy_data(2, 85, seed)
    jm = jax_build_model("uno9", dtype=dtype, **KW)
    tree = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(x))

    def loss(p):
        out = jm.apply(p, jnp.asarray(x)).reshape(2, 85, 85)
        return j_relative_lp_loss(out, jnp.asarray(y), reduction="sum")

    set_fused_head_mode(fused)
    try:
        jl, jg = jax.jit(jax.value_and_grad(loss))(tree)
    finally:
        set_fused_head_mode(None)
    model = _port_model(jax.tree.map(np.asarray, tree), dtype)
    tl = relative_lp_loss(model(torch.from_numpy(x)).reshape(2, 85, 85),
                          torch.from_numpy(y), reduction="sum")
    tl.backward()
    return tl.item(), _port_grads(model), float(jl), _flat_tree(jg), tree


def test_uno9_loss_and_gradients_match_uno_tpu_f32():
    tl, tg, jl, jg, _ = _grads_both("float32", fused=False)
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    assert set(tg) == set(jg)
    total = np.sqrt(sum(np.linalg.norm(g) ** 2 for g in jg.values()))
    normed = {i for i, b in enumerate(jax_build_model("uno9", **KW).spec.blocks) if b.normalize}
    for path, g in tg.items():
        want = np.conj(jg[path])  # no-op on real leaves
        assert g.shape == want.shape, path
        if path[1:] == ("w", "bias") and int(path[0][len("block"):]) in normed:
            assert max(np.linalg.norm(g), np.linalg.norm(want)) <= 1e-6 * total, path
        else:
            assert _rel(g, want) <= 1e-4, (path, _rel(g, want))


def test_uno9_bf16_gradients_are_as_accurate_as_uno_tpus():
    _, tg, _, jg, tree = _grads_both("bfloat16", fused=True, seed=1)
    x, y = _darcy_data(2, 85, 1)
    j32 = jax_build_model("uno9", **KW)

    def loss32(p):
        out = j32.apply(p, jnp.asarray(x)).reshape(2, 85, 85)
        return j_relative_lp_loss(out, jnp.asarray(y), reduction="sum")

    g32 = _flat_tree(jax.jit(jax.grad(loss32))(tree))
    for path, g in tg.items():
        assert np.isfinite(g).all(), path
        truth = np.conj(g32[path])
        err_port = _rel(g, truth)
        err_jax = _rel(np.conj(np.asarray(jg[path], np.complex128)), truth)
        assert err_port <= 2.0 * err_jax + 0.02, (path, err_port, err_jax)


# "across_steplr": 4 epochs at StepLR(1, 0.5), so the learning rate halves
# three times, and a val set whose last 3 targets are negated, so val falls,
# rises and falls again: a best-val pattern with a miss in it
@pytest.mark.parametrize("epochs,lr,sched,negated", [(2, 1e-3, 100, 0), (4, 5e-2, 1, 3)],
                         ids=["short", "across_steplr"])
def test_train_darcy_matches_uno_tpu(epochs, lr, sched, negated):
    x, y = _darcy_data(16, 85)
    xv, yv = _darcy_data(8, 85, seed=1)
    yv[len(yv) - negated:] *= -1
    kw = dict(epochs=epochs, batch_size=8, learning_rate=lr, weight_decay=1e-3, seed=0,
              scheduler_step=sched)
    jm = jax_build_model("uno9", **KW)
    jrec = _JRecords()
    jout = j_train_darcy(jm, x, y, xv, yv, xv, yv, JTrainConfig(**kw), logger=jrec)
    # uno_tpu's trainer draws its init from PRNGKey(seed) on x_train[:1]
    tree = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    model = _port_model(jax.tree.map(np.asarray, tree))
    trec = _Records()
    tout = train_darcy(model, x, y, xv, yv, xv, yv, TrainConfig(**kw), logger=trec)

    jepochs = [r for r in jrec.records if "epoch" in r]
    tepochs = [r for r in trec.records if "epoch" in r]
    assert len(tepochs) == len(jepochs) == epochs
    assert [r["saved"] for r in tepochs] == [r["saved"] for r in jepochs]
    assert [r["lr"] for r in tepochs] == pytest.approx([r["lr"] for r in jepochs], rel=1e-12)
    for tr, jr in zip(tepochs, jepochs):
        assert set(tr) - {"t"} == set(jr) | {"step_ms"}
        assert (tr["epoch"], tr["step"]) == (jr["epoch"], jr["step"])
        assert len(tr["step_ms"]) == 2
        for k in ("train_rel_l2", "val_rel_l2"):
            assert tr[k] == pytest.approx(jr[k], rel=1e-3), (k, tr[k], jr[k])
    if negated:  # the case sees what it is there for
        assert len({r["lr"] for r in tepochs}) == epochs
        assert not all(r["saved"] for r in tepochs)
    assert tout["test_rel_l2"] == pytest.approx(jout["test_rel_l2"], rel=1e-3)
    assert tout["step"] == 2 * epochs
    got = _flat_tree(bridge.params_to_flax(model))
    want = _flat_tree(jout["params"])
    for path, w in want.items():
        assert _rel(got[path], w) <= 1e-3, (path, _rel(got[path], w))


def test_train_darcy_loss_decreases():
    model = build_model("uno9", generator=torch.Generator().manual_seed(0), **KW)
    x, y = _darcy_data(16, 85)
    xv, yv = _darcy_data(8, 85, seed=1)
    cfg = TrainConfig(epochs=3, batch_size=8, learning_rate=1e-3, weight_decay=0.0)
    rec = _Records()
    out = train_darcy(model, x, y, xv, yv, xv, yv, cfg, logger=rec)
    losses = [r["train_rel_l2"] for r in rec.records if "train_rel_l2" in r]
    assert losses[-1] < losses[0], losses
    assert np.isfinite(out["test_rel_l2"])


@pytest.mark.parametrize("n,bs,shuffle,drop", [(10, 4, True, False), (10, 4, True, True),
                                               (12, 4, False, False), (7, 8, True, False)])
def test_epoch_batches_match_uno_tpus(n, bs, shuffle, drop):
    from uno_tpu.data.batching import epoch_batches as j_epoch_batches
    from uno_tpu.data.batching import num_batches as j_num_batches
    from uno_tpu_torch.data.batching import epoch_batches, num_batches

    got = list(epoch_batches(np.random.default_rng(3), n, bs, shuffle, drop))
    want = list(j_epoch_batches(np.random.default_rng(3), n, bs, shuffle, drop))
    assert len(got) == len(want) == num_batches(n, bs, drop) == j_num_batches(n, bs, drop)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("s", [85, 128])
def test_evaluate_darcy_matches_uno_tpus(s):
    """At the training grid and at another: the weights are resolution-free."""
    from uno_tpu.train.evaluate import evaluate_darcy as j_evaluate_darcy
    from uno_tpu_torch.train.evaluate import evaluate_darcy

    x, y = _darcy_data(3, s, seed=4)
    jm = jax_build_model("uno9", **KW)
    tree = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(_darcy_data(1, 85)[0]))
    want = j_evaluate_darcy(jm, tree, x, y, batch_size=2)
    got = evaluate_darcy(_port_model(jax.tree.map(np.asarray, tree)), x, y, batch_size=2)
    assert got == pytest.approx(want, rel=1e-5)


class _SigTermAfterEpoch(_Records):
    """Sends SIGTERM to this process once epoch ``at`` is logged: the trainer
    must finish that epoch and return, as tests/test_graceful_stop.py checks
    of uno_tpu's."""

    def __init__(self, at):
        super().__init__()
        self.at = at

    def log(self, record):
        super().log(record)
        if record.get("epoch") == self.at:
            os.kill(os.getpid(), signal.SIGTERM)


def test_sigterm_stops_training_after_the_epoch():
    model = build_model("uno9", generator=torch.Generator().manual_seed(0), **KW)
    x, y = _darcy_data(8, 85)
    prev = signal.getsignal(signal.SIGTERM)
    rec = _SigTermAfterEpoch(at=0)
    out = train_darcy(model, x, y, x, y, x, y,
                      TrainConfig(epochs=3, batch_size=8, weight_decay=0.0), logger=rec)
    assert out["stopped_early"] is True and out["step"] == 1
    assert [r["epoch"] for r in rec.records if "epoch" in r] == [0]
    assert any("stopped_early_after_epoch" in r for r in rec.records)
    assert signal.getsignal(signal.SIGTERM) == prev


def test_training_after_inference_in_one_process():
    """Serving, then training, in one process: the resample tables are cached
    per process, and one first built under inference mode must still be
    usable by autograd."""
    from uno_tpu_torch.ops import resample

    resample._table.cache_clear()
    model = build_model("uno9", generator=torch.Generator().manual_seed(0), **KW)
    x = torch.from_numpy(_darcy_data(1, 85)[0])
    with torch.inference_mode():
        model(x)
    model(x).square().mean().backward()
    assert all(p.grad is not None for p in model.parameters())


def test_train_config_raises_on_fields_not_ported():
    # channel tensor parallelism is ported (parallel/tp.py)
    assert TrainConfig(tensor_parallel=True).tensor_parallel is True
    # TensorBoard logging is ported
    assert TrainConfig(log_tensorboard="tb").log_tensorboard == "tb"
    # checkpoints are ported
    cfg = TrainConfig(checkpoint_dir="ck", resume=True, checkpoint_every=2)
    assert (cfg.checkpoint_dir, cfg.resume, cfg.checkpoint_every) == ("ck", True, 2)


def _split_cache(path, s=85, ntrain=2, nval=1, ntest=1):
    x, y = _darcy_data(ntrain + nval + ntest, s)
    i, j = ntrain, ntrain + nval
    sig = f"task=darcy,sub=5,ntrain={ntrain},nval={nval},ntest={ntest},seed=10001"
    np.savez(path, train_a=x[:i], train_u=y[:i], val_a=x[i:j], val_u=y[i:j],
             test_a=x[j:], test_u=y[j:], config_sig=np.asarray(sig))


def test_cli_train_prints_jsonl(tmp_path, capsys):
    data, log = str(tmp_path / "d.npz"), str(tmp_path / "run.jsonl")
    _split_cache(data)
    rc = cli.main(["train", "--preset", "darcy_s85", "--data-cache", data,
                   "--ntrain", "2", "--nval", "1", "--ntest", "1", "--epochs", "1",
                   "--batch-size", "2", "--dtype", "bfloat16", "--device", "cpu",
                   "--log", log])
    assert rc == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert set(lines[0]) == RECORD_KEYS | {"step_ms"}
    assert lines[0]["step"] == 1 and lines[0]["lr"] == 1e-3
    assert np.isfinite(lines[-1]["test_rel_l2"])
    with open(log) as f:
        assert [json.loads(l) for l in f] == lines


def test_cli_train_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    data = str(tmp_path / "d.npz")
    _split_cache(data)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["train", "--preset", "darcy_s85", "--data-cache", data,
                  "--ntrain", "2", "--nval", "1", "--ntest", "1", "--device", "cuda"])
    assert not os.path.exists(str(tmp_path / "run.jsonl"))
