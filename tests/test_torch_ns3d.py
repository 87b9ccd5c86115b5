"""The port's NS-3D path against uno_tpu: the uno3d models, the one-shot
spatiotemporal trainer, its evaluator and the CLI.

The same numpy inputs and the same weights go through both packages on the
CPU.  The weights are the port's init, carried to flax by
uno_tpu_torch.bridge (a flax init of a 3-D model compiles for ~15 s on the
CPU; the bridge's shapes and names are held against ``jax.eval_shape`` of
uno_tpu's init instead).  Torch's gradient of a complex weight is the
conjugate of ``jax.grad``'s, so complex leaves are compared conjugated.
Bounds:

* forward: rel-L2 <= 1e-4 at f32 (FFT and summation orders differ); <=
  2e-2 under the bf16 policy, the bound of tests/test_torch_model.py; the
  same on the partial-DFT path (both packages under ``set_dft_mode(True)``),
  where a training step's gradients are held as on the FFT path;
* one training step's loss rel 1e-5 and every gradient leaf rel-L2 <= 1e-4
  at f32;
* trainer: each logged rel-L2 within rel 1e-3 of uno_tpu's ``train_ns3d``
  over a run stopped by SIGTERM after epoch 1 and resumed, final params
  rel-L2 <= 1e-3 per leaf; ``evaluate_ns3d`` rel 1e-5.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_checkpoint import _JStop, _Stop
from tests.test_torch_train import _flat_tree, _JRecords, _port_grads, _Records, _rel
from uno_tpu.losses import relative_lp_loss as j_relative_lp_loss
from uno_tpu.models import build_model as jax_build_model
from uno_tpu.ops import spectral as jspec
from uno_tpu.train import TrainConfig as JTrainConfig
from uno_tpu.train import train_ns3d as j_train_ns3d
from uno_tpu.train.evaluate import evaluate_ns3d as j_evaluate_ns3d
from uno_tpu_torch import bridge, cli
from uno_tpu_torch.losses import relative_lp_loss
from uno_tpu_torch.models import build_model, core
from uno_tpu_torch.ops.spectral import set_dft_mode
from uno_tpu_torch.train.checkpoint import CheckpointManager
from uno_tpu_torch.train.common import TrainConfig
from uno_tpu_torch.train.evaluate import evaluate_ns3d
from uno_tpu_torch.train.ns3d import forecast, train_ns3d
from _threads import worker_share_of_threads  # noqa: F401,E402

# uno3d_t10 at width 2 on a 32x32 grid: the smallest its fixed modes allow
# (22 at 3/4 of the grid, 6 at 1/4)
T10 = dict(in_width=6, width=2, pad=2)
S, T_IN, T_F = 32, 10, 10


@pytest.fixture(autouse=True)
def jax_fft():
    """uno_tpu on its FFT path, the port's default."""
    jspec.set_dft_mode(False)
    yield
    jspec.set_dft_mode(None)


@pytest.fixture
def dft_mode():
    """Both packages on the partial-DFT path."""
    jspec.set_dft_mode(True)
    set_dft_mode(True)
    yield
    jspec.set_dft_mode(False)
    set_dft_mode(None)


def _ns_data(n, seed=0, s=S, t_in=T_IN, t_f=T_F):
    """Input windows of unit scale and a target a forecast can learn: the
    last input frame plus small noise."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, s, s, t_in)).astype(np.float32)
    u = (0.1 * rng.standard_normal((n, s, s, t_f)) + a[..., -1:]).astype(np.float32)
    return a, u


def _port(name, kw, dtype=None, seed=0):
    return build_model(name, dtype=dtype, generator=torch.Generator().manual_seed(seed), **kw)


def _tree(model):
    return jax.tree.map(jnp.asarray, bridge.params_to_flax(model))


# (name, kwargs, S, T_in): uno3d_t40 at width 4 on the 64x64 grid (pad 3 ->
# 3 time steps, crop 4 * 3 = 12 of 52); uno3d_t9 (T_in 6: pad int(2 * 0.1 *
# 6) = 1, crop floor(3/2 * 1) = 1); uno3d_t10 (crop 1 x pad); uno3d_t20
# padded on both sides
MODEL_CASES = [
    ("uno3d_t40", dict(in_width=6, width=4, pad=3), 64, 10, 40),
    ("uno3d_t9", dict(in_width=6, width=2, pad=2), 40, 6, 9),
    ("uno3d_t10", T10, S, T_IN, 10),
    ("uno3d_t20", dict(in_width=6, width=2, pad=2, pad_both=True), 48, 10, 20),
]


@pytest.mark.parametrize("name,kw,s,t_in,t_out", MODEL_CASES)
def test_uno3d_forward_matches_uno_tpu_f32(name, kw, s, t_in, t_out):
    x = np.random.default_rng(1).standard_normal((1, s, s, t_in, 1)).astype(np.float32)
    model = _port(name, kw)
    jm = jax_build_model(name, **kw)
    want = np.asarray(jax.jit(jm.apply)(_tree(model), jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape == (1, s, s, t_out, 1)
    assert _rel(got.numpy(), want) <= 1e-4, _rel(got.numpy(), want)


def test_uno3d_t40_forward_matches_uno_tpu_bf16(monkeypatch):
    """Under bf16 a 3-D model projects through the unfused f32 Dense head,
    as uno_tpu's does: the fused head kernel is never called."""
    name, kw, s, t_in, t_out = MODEL_CASES[0]
    x = np.random.default_rng(2).standard_normal((1, s, s, t_in, 1)).astype(np.float32)
    model = _port(name, kw, "bfloat16")
    jm = jax_build_model(name, dtype="bfloat16", **kw)
    want = np.asarray(jax.jit(jm.apply)(_tree(model), jnp.asarray(x)), np.float32)

    def refuse(*args, **kwargs):
        raise AssertionError("the fused head was called on the 3-D path")

    monkeypatch.setattr(core, "mlp_head", refuse)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape == (1, s, s, t_out, 1)
    assert _rel(got.numpy(), want) <= 2e-2, _rel(got.numpy(), want)


@pytest.mark.parametrize("dtype,bound", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_uno3d_t40_on_the_dft_path_matches_uno_tpu(dtype, bound, dft_mode):
    """uno3d_t40 at width 4 on the 64x64 grid, both packages on the
    partial-DFT path; under bf16 the DFT transforms keep bf16 operands, as
    uno_tpu's do."""
    name, kw, s, t_in, t_out = MODEL_CASES[0]
    x = np.random.default_rng(3).standard_normal((1, s, s, t_in, 1)).astype(np.float32)
    model = _port(name, kw, dtype)
    jm = jax_build_model(name, dtype=dtype, **kw)
    want = np.asarray(jax.jit(jm.apply)(_tree(model), jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape == (1, s, s, t_out, 1)
    assert _rel(got.numpy(), want) <= bound, _rel(got.numpy(), want)


def test_bridge_carries_a_3d_model_both_ways():
    """The port's parameter names and shapes are uno_tpu's (its init's tree,
    from ``jax.eval_shape``), the spectral weights (4, Ci, Co, m1, m2, m3);
    a round trip through the flax tree is bit-exact."""
    model = _port("uno3d_t10", T10)
    x = jnp.zeros((1, S, S, T_IN, 1), jnp.float32)
    shapes = jax.eval_shape(jax_build_model("uno3d_t10", **T10).init, jax.random.PRNGKey(0), x)
    want = {tuple(k.key for k in kp): tuple(v.shape)
            for kp, v in jax.tree_util.tree_leaves_with_path(shapes["params"])}
    got = {k: v.shape for k, v in _flat_tree(bridge.params_to_flax(model)).items()}
    assert got == want
    assert want[("block0", "conv", "weights")] == (4, 2, 2 * 2, 22, 22, 5)
    again = bridge.params_from_flax(_port("uno3d_t10", T10, seed=5),
                                    bridge.params_to_flax(model))
    for (k, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k


def test_train_step_loss_and_gradients_match_jax_value_and_grad():
    """The trainer's loss (the full-field rel-L2 of the forecast, summed) and
    its gradients against ``jax.value_and_grad`` of uno_tpu's."""
    _check_step_loss_and_gradients()


def test_train_step_on_the_dft_path_matches_jax_value_and_grad(dft_mode):
    """The same with both packages on the partial-DFT path: the hand-written
    backward of the 3-D conv and truncation against JAX's."""
    _check_step_loss_and_gradients()


def _check_step_loss_and_gradients():
    a, u = _ns_data(2)
    model = _port("uno3d_t10", T10)
    jm = jax_build_model("uno3d_t10", **T10)

    def loss(p, x, y):
        out = jm.apply(p, x[..., None]).reshape(x.shape[0], S, S, T_F)
        return j_relative_lp_loss(out, y, reduction="sum")

    jl, jg = jax.jit(jax.value_and_grad(loss))(_tree(model), jnp.asarray(a), jnp.asarray(u))
    got = relative_lp_loss(forecast(model, torch.from_numpy(a), T_F), torch.from_numpy(u))
    got.backward()
    assert got.item() == pytest.approx(float(jl), rel=1e-5)
    grads, want = _port_grads(model), _flat_tree(jg)
    assert set(grads) == set(want)
    scale = np.sqrt(sum(np.linalg.norm(w) ** 2 for w in want.values()))
    normalized = {f"block{i}" for i, b in enumerate(model.spec.blocks) if b.normalize}
    for path, g in grads.items():
        if path[0] in normalized and path[1:] == ("w", "bias"):
            # the instance norm cancels a per-channel constant: this gradient
            # is zero but for rounding, on both sides
            assert max(np.abs(g).max(), np.abs(want[path]).max()) <= 1e-6 * scale, path
            continue
        assert np.linalg.norm(g) > 0, path
        assert _rel(g, np.conj(want[path])) <= 1e-4, (path, _rel(g, np.conj(want[path])))


class _FixedInit:
    """uno_tpu's model with its ``init`` returning given params: both
    trainers start from the port's weights, and uno_tpu's skips its init
    compile."""

    def __init__(self, jm, tree):
        self.jm, self.tree = jm, tree

    def init(self, key, x):
        return self.tree

    def apply(self, params, x):
        return self.jm.apply(params, x)


def test_train_ns3d_stop_and_resume_match_uno_tpu(tmp_path):
    """Three epochs with validation every 2 (epochs 0 and 2), stopped by
    SIGTERM after epoch 1 and resumed: the records of both packages, the
    checkpoint saved on each improvement of the per-step val loss, and the
    final params."""
    a, u = _ns_data(6, seed=3)
    kw = dict(epochs=3, batch_size=2, learning_rate=3e-3, weight_decay=1e-5, seed=0,
              eval_every=2, scheduler_step=1, checkpoint_every=0)
    split = (a[:2], u[:2], a[2:4], u[2:4], a[4:], u[4:])  # one step per epoch
    init = _port("uno3d_t10", T10)
    jm = _FixedInit(jax_build_model("uno3d_t10", **T10), _tree(init))
    jck, tck = str(tmp_path / "jck"), str(tmp_path / "tck")
    legs = []
    for resume in (False, True):
        jrec = _JRecords() if resume else _JStop(at=1)
        jout = j_train_ns3d(jm, *split, JTrainConfig(checkpoint_dir=jck, resume=resume, **kw),
                            t_f=T_F, logger=jrec)
        trec = _Records() if resume else _Stop(at=1)
        model = _port("uno3d_t10", T10)  # the port's init, as uno_tpu's
        tout = train_ns3d(model, *split, TrainConfig(checkpoint_dir=tck, resume=resume, **kw),
                          t_f=T_F, logger=trec)
        legs.append((jrec.records, jout, trec.records, tout))

    (j1, jo1, t1, to1), (j2, jo2, t2, to2) = legs
    assert jo1["stopped_early"] and to1["stopped_early"]
    assert not jo2["stopped_early"] and not to2["stopped_early"]
    for jr, tr, epochs in ((j1, t1, [0, 1]), (j2, t2, [2])):
        je = [r for r in jr if "epoch" in r]
        te = [r for r in tr if "epoch" in r]
        assert [r["epoch"] for r in te] == [r["epoch"] for r in je] == epochs
        for a_, b_ in zip(te, je):
            assert set(a_) - {"t"} == set(b_) - {"t"} | {"step_ms"}
            assert ("val_step_rel_l2" in a_) == (a_["epoch"] % 2 == 0)
            assert a_["step"] == b_["step"] and a_.get("saved") == b_.get("saved")
            assert a_["lr"] == pytest.approx(b_["lr"], rel=1e-12)
            assert len(a_["step_ms"]) == 1
            for k in ("train_step_rel_l2", "val_step_rel_l2", "val_full_rel_l2"):
                if k in b_:
                    assert a_[k] == pytest.approx(b_[k], rel=1e-3), (k, a_[k], b_[k])
    assert [r["lr"] for r in t1 + t2 if "lr" in r] == pytest.approx([3e-3, 1.5e-3, 7.5e-4])
    for k in ("test_full_rel_l2", "test_step_rel_l2"):
        assert to2[k] == pytest.approx(jo2[k], rel=1e-3), (k, to2[k], jo2[k])
    assert to2["step"] == 3 and to2["best_val"] == pytest.approx(jo2["best_val"], rel=1e-3)
    got = _flat_tree(bridge.params_to_flax(_load(to2["params"])))
    for path, w in _flat_tree(jo2["params"]).items():
        assert _rel(got[path], w) <= 1e-3, (path, _rel(got[path], w))
    assert CheckpointManager(tck).exists("best_params")


def test_train_ns3d_across_steplr_matches_uno_tpu():
    """Five epochs uninterrupted at StepLR(1, 0.5), validation every 2
    (epochs 0, 2 and 4), the val targets of one sample negated so that the
    per-step val loss rises and falls: the saved pattern, the learning rate
    of every epoch, each logged loss, the test pass on the best-val params
    and those params, as uno_tpu's."""
    a, u = _ns_data(6, seed=3)
    u[3] *= -1
    kw = dict(epochs=5, batch_size=2, learning_rate=3e-2, weight_decay=1e-5, seed=0,
              eval_every=2, scheduler_step=1)
    split = (a[:2], u[:2], a[2:4], u[2:4], a[4:], u[4:])  # one step per epoch
    init = _port("uno3d_t10", T10)
    jrec, trec = _JRecords(), _Records()
    jout = j_train_ns3d(_FixedInit(jax_build_model("uno3d_t10", **T10), _tree(init)), *split,
                        JTrainConfig(**kw), t_f=T_F, logger=jrec)
    tout = train_ns3d(_port("uno3d_t10", T10), *split, TrainConfig(**kw), t_f=T_F, logger=trec)

    je = [r for r in jrec.records if "epoch" in r]
    te = [r for r in trec.records if "epoch" in r]
    assert [r["epoch"] for r in te] == [r["epoch"] for r in je] == list(range(5))
    assert [r.get("saved") for r in te] == [r.get("saved") for r in je]
    assert [r["lr"] for r in te] == pytest.approx([r["lr"] for r in je], rel=1e-12)
    assert len({r["lr"] for r in te}) == 5
    assert [r["saved"] for r in te if "saved" in r] != [True] * 3
    for a_, b_ in zip(te, je):
        for k in ("train_step_rel_l2", "val_step_rel_l2", "val_full_rel_l2"):
            assert (k in a_) == (k in b_), k
            if k in b_:
                assert a_[k] == pytest.approx(b_[k], rel=1e-3), (k, a_[k], b_[k])
    for k in ("test_full_rel_l2", "test_step_rel_l2"):
        assert tout[k] == pytest.approx(jout[k], rel=1e-3), (k, tout[k], jout[k])
    assert tout["best_val"] == pytest.approx(jout["best_val"], rel=1e-3)
    got = _flat_tree(bridge.params_to_flax(_load(tout["params"])))
    for path, w in _flat_tree(jout["params"]).items():
        assert _rel(got[path], w) <= 1e-3, (path, _rel(got[path], w))


def _load(state):
    model = _port("uno3d_t10", T10)
    model.load_state_dict(state)
    return model


def test_best_params_follow_the_per_step_val_loss(monkeypatch):
    """Model selection reads ``val_step_rel_l2``, not the full-field loss:
    with the evaluation's two numbers forced apart, the saved epochs follow
    the per-step loss."""
    from uno_tpu_torch.train import ns3d

    a, u = _ns_data(4, seed=6)
    full = iter([0.5, 0.4, 0.3])  # the full-field loss falls at every validation
    step = iter([0.5, 0.7, 0.2])  # the per-step loss rises at the second
    real = ns3d.step_rel_l2

    # validation's (B, S, S, T) output does not require grad; training's
    # does (the logged step loss flattens it to (B * T, S * S) first)
    def fake_relative_lp_loss(out, y, reduction="sum", group=None):
        if out.ndim == 4 and not out.requires_grad:
            return torch.tensor(next(full) * len(out))
        return relative_lp_loss(out, y, reduction=reduction, group=group)

    def fake_step(out, y, group=None):
        if not out.requires_grad:
            return torch.tensor(next(step) * len(out) * T_F)
        return real(out, y, group)

    monkeypatch.setattr(ns3d, "relative_lp_loss", fake_relative_lp_loss)
    monkeypatch.setattr(ns3d, "step_rel_l2", fake_step)
    rec = _Records()
    cfg = TrainConfig(epochs=3, batch_size=2, seed=0, eval_every=1)
    out = train_ns3d(_port("uno3d_t10", T10), a[:2], u[:2], a[2:], u[2:], a[:0], u[:0], cfg,
                     t_f=T_F, logger=rec)
    evals = [r for r in rec.records if "val_step_rel_l2" in r]
    assert [r["val_full_rel_l2"] for r in evals] == pytest.approx([0.5, 0.4, 0.3])
    assert [r["val_step_rel_l2"] for r in evals] == pytest.approx([0.5, 0.7, 0.2])
    assert [r["saved"] for r in evals] == [True, False, True]
    assert out["best_val"] == pytest.approx(0.2)


def test_evaluate_ns3d_matches_uno_tpus():
    a, u = _ns_data(3, seed=4)  # a partial last batch
    model = _port("uno3d_t10", T10)
    jm = jax_build_model("uno3d_t10", **T10)
    want = j_evaluate_ns3d(jm, _tree(model), a, u, T_F, batch_size=2)
    got = evaluate_ns3d(model, a, u, T_F, batch_size=2)
    assert set(got) == set(want) == {"field_rel_l2", "step_rel_l2"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), (k, got[k], want[k])


def _write_cache(path, preset, ntrain, nval, ntest, seed=7):
    a, u = _ns_data(ntrain + nval + ntest, seed, s=preset.size)
    i, j = ntrain, ntrain + nval
    p = dataclasses.replace(preset, ntrain=ntrain, nval=nval, ntest=ntest)
    np.savez(path, train_a=a[:i], train_u=u[:i], val_a=a[i:j], val_u=u[i:j], test_a=a[j:],
             test_u=u[j:], config_sig=np.asarray(cli._gen_sig(p)))
    return a[j:], u[j:]


def test_cli_train_eval_predict_ns3d(tmp_path, capsys):
    """``cli train``, ``eval`` and ``predict --preset ns3d_t10`` on a tiny
    split at 32x32 (the preset's model at its width 8): the trainer's
    records, the checkpoint's metrics, and predictions equal to a forecast
    of the restored best params."""
    from uno_tpu_torch.configs import presets

    preset = dataclasses.replace(presets.PRESETS["ns3d_t10"], size=S)
    data, ck, out = str(tmp_path / "ns3d.npz"), str(tmp_path / "ck"), str(tmp_path / "p.npz")
    test_a, test_u = _write_cache(data, preset, 2, 2, 3)
    split = ["--preset", "ns3d_t10", "--data-cache", data, "--size", str(S), "--ntrain", "2",
             "--nval", "2", "--ntest", "3", "--batch-size", "2", "--device", "cpu"]
    assert cli.main(["train", *split, "--epochs", "2", "--checkpoint-dir", ck]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    epochs = [r for r in lines if "epoch" in r]
    assert [r["epoch"] for r in epochs] == [0, 1] and "val_step_rel_l2" in epochs[0]
    assert all(r["task"] == "ns3d" for r in lines)
    assert np.isfinite([lines[-1]["test_full_rel_l2"], lines[-1]["test_step_rel_l2"]]).all()

    assert cli.main(["eval", *split, "--checkpoint-dir", ck]) == 0
    report = [json.loads(x) for x in capsys.readouterr().out.splitlines()
              if x.startswith("{")][-1]
    assert {"val_field_rel_l2", "val_step_rel_l2", "test_field_rel_l2",
            "test_step_rel_l2"} <= set(report)
    assert report["test_field_rel_l2"] == pytest.approx(lines[-1]["test_full_rel_l2"], rel=1e-5)

    assert cli.main(["predict", *split, "--checkpoint-dir", ck, "--out", out]) == 0
    report = [json.loads(x) for x in capsys.readouterr().out.splitlines()
              if x.startswith("{")][-1]
    assert report["n"] == 3 and len(report["batch_ms"]) == 2
    z = np.load(out)
    model = build_model("uno3d_t10", generator=torch.Generator().manual_seed(0),
                        **preset.model_kwargs)
    model.load_state_dict(CheckpointManager(ck).restore("best_params"))
    with torch.no_grad():
        want = forecast(model, torch.from_numpy(test_a), T_F).numpy()
    assert z["pred"].shape == (3, S, S, T_F)
    np.testing.assert_allclose(z["pred"], want, rtol=0, atol=1e-5)
    assert np.array_equal(z["target"], test_u)


def test_ns3d_presets_build_their_models():
    """Every NS-3D preset's model at its published widths (the time axis out
    of one forward is T_f); the _256 factories through the same code."""
    from uno_tpu_torch.configs import presets

    for name in ("ns3d_t40", "ns3d_t20", "ns3d_t10", "ns3d_t9"):
        p = presets.PRESETS[name]
        model = build_model(p.model, generator=torch.Generator().manual_seed(0),
                            device="meta", **p.model_kwargs)
        assert model.spec.ndim == 3 and p.task == "ns3d"
        assert model.block0.conv.weights.shape[0] == 4
    # the 256 family's modes need a 128 grid at least (32 modes at 1/4)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((1, 128, 128, 6, 1))
                         .astype(np.float32))
    model = build_model("uno3d_t9_256", generator=torch.Generator().manual_seed(0),
                        in_width=6, width=2, pad=2)
    with torch.no_grad():
        got = model(x)
    assert got.shape == (1, 128, 128, 9, 1) and torch.isfinite(got).all()
