"""The port's NS-2D path against uno_tpu: the ``uno`` model, the rollout,
the trainer and the evaluator.

``uno`` at width 8 on the 64x64 grid (the smallest its fixed modes allow,
as uno_tpu's tests/test_train.py uses), batch 2, T_f = 3.  The same numpy
inputs and one flax init (through uno_tpu_torch.bridge) go through both
packages on the CPU; uno_tpu's rollout and its ``jax.grad`` are compiled
once per file.  Torch's gradient of a complex weight is the conjugate of
``jax.grad``'s, so complex leaves are compared conjugated.  Bounds:

* ``uno`` forward: rel-L2 <= 1e-4 at f32; <= 3e-2 under the bf16 policy
  with the fused head on both sides (uno_tpu's in interpret mode);
* rollout: the summed step loss rel 1e-5, the predicted trajectory rel-L2
  <= 1e-4 and every gradient leaf rel-L2 <= 1e-4 at f32 (FFT and summation
  orders differ; three steps feed each error back).  Under bf16 each
  leaf's gradient is no further from uno_tpu's f32 gradient than 2x
  uno_tpu's own bf16 error + 0.02 (the ratio test of
  tests/test_torch_train.py);
* rematerialisation changes no bit: gradients with ``remat=True`` equal
  those with ``remat=False`` exactly, on the CPU;
* trainer: each logged rel-L2 within rel 1e-3 of uno_tpu's ``train_ns2d``
  over a run stopped by SIGTERM after epoch 1 and resumed, final params
  rel-L2 <= 1e-3 per leaf; ``evaluate_ns2d`` rel 1e-5.
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
from uno_tpu.models import build_model as jax_build_model
from uno_tpu.ops.pallas.mlp_head import set_fused_head_mode
from uno_tpu.train import TrainConfig as JTrainConfig
from uno_tpu.train import train_ns2d as j_train_ns2d
from uno_tpu.train.evaluate import evaluate_ns2d as j_evaluate_ns2d
from uno_tpu.train.ns2d import make_rollout as j_make_rollout
from uno_tpu_torch import bridge, cli
from uno_tpu_torch.configs import presets
from uno_tpu_torch.models import build_model
from uno_tpu_torch.train import ns2d
from uno_tpu_torch.train.common import TrainConfig
from uno_tpu_torch.train.evaluate import evaluate_ns2d
from uno_tpu_torch.train.ns2d import make_rollout, train_ns2d

KW = dict(in_width=14, width=8, pad=0)
S, T_IN, T_F = 64, 10, 3


def _ns_data(n, seed=0, t_f=T_F):
    """Inputs of unit scale and a target that a rollout can learn: the last
    input frame plus small noise (uno_tpu's tests/test_train.py)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, S, S, T_IN)).astype(np.float32)
    u = (0.1 * rng.standard_normal((n, S, S, t_f)) + a[..., -1:]).astype(np.float32)
    return a, u


def _port(tree, dtype=None):
    model = build_model("uno", dtype=dtype, generator=torch.Generator().manual_seed(1), **KW)
    return bridge.params_from_flax(model, tree)


def _jax_rollout_grads(jm, tree, x, y, fused):
    rollout = j_make_rollout(jm, T_F)

    def loss(p):
        return rollout(p, jnp.asarray(x), jnp.asarray(y))

    set_fused_head_mode(fused)
    try:
        (jl, pred), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(tree)
    finally:
        set_fused_head_mode(None)
    return float(jl), np.asarray(pred), _flat_tree(jg)


@pytest.fixture(scope="module")
def ref():
    """One flax init of ``uno`` and uno_tpu's f32 rollout at T_f = 3 on it:
    loss, trajectory and gradients, compiled once for the file."""
    x, y = _ns_data(2)
    jm = jax_build_model("uno", **KW)
    tree = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    loss, pred, grads = _jax_rollout_grads(jm, tree, x, y, fused=False)
    return dict(x=x, y=y, tree=tree, loss=loss, pred=pred, grads=grads)


def _port_rollout(ref, dtype=None, remat=True):
    model = _port(ref["tree"], dtype)
    loss, pred = make_rollout(model, T_F, remat)(torch.from_numpy(ref["x"]),
                                                 torch.from_numpy(ref["y"]))
    loss.backward()
    return loss.item(), pred.detach(), _port_grads(model)


@pytest.mark.parametrize("dtype,bound", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_uno_forward_matches_uno_tpu(ref, dtype, bound):
    jm = jax_build_model("uno", dtype=dtype, **KW)
    set_fused_head_mode(dtype == "bfloat16")
    try:
        want = np.asarray(jax.jit(jm.apply)(ref["tree"], jnp.asarray(ref["x"])), np.float32)
    finally:
        set_fused_head_mode(None)
    with torch.no_grad():
        got = _port(ref["tree"], dtype)(torch.from_numpy(ref["x"])).numpy()
    assert got.shape == want.shape == (2, S, S, 1) and got.dtype == np.float32
    assert _rel(got, want) <= bound, _rel(got, want)


def test_rollout_loss_pred_and_gradients_match_jax_grad_f32(ref):
    loss, pred, grads = _port_rollout(ref)
    assert loss == pytest.approx(ref["loss"], rel=1e-5)
    assert pred.shape == (2, S, S, T_F) and pred.dtype == torch.float32
    assert _rel(pred.numpy(), ref["pred"]) <= 1e-4
    assert set(grads) == set(ref["grads"])
    for path, g in grads.items():
        want = np.conj(ref["grads"][path])  # no-op on real leaves
        assert g.shape == want.shape, path
        assert np.linalg.norm(g) > 0, path  # every step feeds every weight
        assert _rel(g, want) <= 1e-4, (path, _rel(g, want))


def test_rollout_bf16_gradients_are_as_accurate_as_uno_tpus(ref):
    jm16 = jax_build_model("uno", dtype="bfloat16", **KW)
    _, _, jg16 = _jax_rollout_grads(jm16, ref["tree"], ref["x"], ref["y"], fused=True)
    _, pred, grads = _port_rollout(ref, "bfloat16")
    assert pred.dtype == torch.float32
    for path, g in grads.items():
        assert np.isfinite(g).all(), path
        truth = np.conj(ref["grads"][path])
        err_port = _rel(g, truth)
        err_jax = _rel(np.conj(np.asarray(jg16[path], np.complex128)), truth)
        assert err_port <= 2.0 * err_jax + 0.02, (path, err_port, err_jax)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_changes_no_bit(ref, dtype):
    on = _port_rollout(ref, dtype, remat=True)
    off = _port_rollout(ref, dtype, remat=False)
    assert on[0] == off[0] and torch.equal(on[1], off[1])
    for path in on[2]:
        assert np.array_equal(on[2][path], off[2][path]), path


def test_serving_rollout_checkpoints_and_saves_nothing(ref, monkeypatch):
    """Under inference mode or no_grad the steps run plainly: no checkpoint,
    and inference tensors out (nothing kept for a backward)."""
    model = _port(ref["tree"], "bfloat16")

    def refuse(*args, **kwargs):
        raise AssertionError("checkpoint called with grad mode off")

    monkeypatch.setattr(ns2d, "checkpoint", refuse)
    rollout = make_rollout(model, T_F)
    x, y = torch.from_numpy(ref["x"]), torch.from_numpy(ref["y"])
    with torch.inference_mode():
        loss, pred = rollout(x, y)
    assert torch.is_inference(pred) and torch.is_inference(loss)
    with torch.no_grad():
        loss2, pred2 = rollout(x, y)
    assert pred2.grad_fn is None and torch.equal(pred, pred2) and torch.equal(loss, loss2)


def test_fed_back_window_stays_f32_under_bf16(ref):
    """Each step's input is f32, and its newest frame is the previous step's
    prediction bit for bit: the window is never rounded to bf16."""
    model = _port(ref["tree"], "bfloat16")
    inputs = []
    model.register_forward_pre_hook(lambda m, args: inputs.append(args[0].detach().clone()))
    loss, pred = make_rollout(model, T_F)(torch.from_numpy(ref["x"]), torch.from_numpy(ref["y"]))
    loss.backward()
    assert len(inputs) == 2 * T_F  # each step's forward, then its recompute
    forward = inputs[:T_F]
    assert all(t.dtype == torch.float32 for t in inputs)
    assert torch.equal(forward[0], torch.from_numpy(ref["x"]))
    for t in range(1, T_F):
        assert torch.equal(forward[t][..., -1], pred[..., t - 1].detach())
        assert torch.equal(forward[t][..., :-1], forward[t - 1][..., 1:])


def test_train_ns2d_stop_and_resume_match_uno_tpu(tmp_path):
    """Three epochs with validation every 2 (epochs 0 and 2), a StepLR that
    decays every epoch counted twice (compat_even_epoch_scheduler), stopped
    by SIGTERM after epoch 1 and resumed: the records of both packages."""
    a, u = _ns_data(6, seed=3)
    kw = dict(epochs=3, batch_size=2, learning_rate=1e-3, weight_decay=1e-5, seed=0,
              eval_every=2, scheduler_step=1, compat_even_epoch_scheduler=True,
              checkpoint_every=0)  # only the stop's save writes train_state
    split = (a[:2], u[:2], a[2:4], u[2:4], a[4:], u[4:])  # one step per epoch
    jm = jax_build_model("uno", **KW)
    tree = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(a[:1])))
    jck, tck = str(tmp_path / "jck"), str(tmp_path / "tck")
    legs = []
    for resume in (False, True):
        jrec = _JRecords() if resume else _JStop(at=1)
        jout = j_train_ns2d(jm, *split, JTrainConfig(checkpoint_dir=jck, resume=resume, **kw),
                            t_f=T_F, logger=jrec)
        trec = _Records() if resume else _Stop(at=1)
        model = _port(tree)  # the resumed leg's init is overwritten by the restore
        tout = train_ns2d(model, *split, TrainConfig(checkpoint_dir=tck, resume=resume, **kw),
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
            for k in ("train_step_rel_l2", "val_step_rel_l2", "val_traj_rel_l2"):
                if k in b_:
                    assert a_[k] == pytest.approx(b_[k], rel=1e-3), (k, a_[k], b_[k])
        assert [r for r in tr if "stopped_early_after_epoch" in r] == (
            [{"task": "ns2d", "stopped_early_after_epoch": 1}] if epochs == [0, 1] else [])
    assert [r["lr"] for r in t1 + t2 if "lr" in r] == pytest.approx([1e-3, 1e-3, 5e-4])
    for k in ("test_step_rel_l2", "test_traj_rel_l2"):
        assert to2[k] == pytest.approx(jo2[k], rel=1e-3), (k, to2[k], jo2[k])
    assert to2["step"] == 3
    model = _port(tree)
    model.load_state_dict(to2["params"])
    got = _flat_tree(bridge.params_to_flax(model))
    for path, w in _flat_tree(jo2["params"]).items():
        assert _rel(got[path], w) <= 1e-3, (path, _rel(got[path], w))


def test_evaluate_ns2d_matches_uno_tpus(ref):
    a, u = _ns_data(3, seed=4)  # a partial last batch
    jm = jax_build_model("uno", **KW)
    want = j_evaluate_ns2d(jm, ref["tree"], a, u, T_F, batch_size=2)
    got = evaluate_ns2d(_port(ref["tree"]), a, u, T_F, batch_size=2)
    assert set(got) == set(want) == {"step_rel_l2", "traj_rel_l2"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), (k, got[k], want[k])


def test_ns2d_s256_two_step_rollout_shapes():
    """ns2d_s256's model (uno_s256, the lift concatenated into an unfused
    head) through a 2-step rollout and its backward at 256x256, width 4."""
    kw = dict(presets.get_preset("ns2d_s256").model_kwargs, width=4)
    for dtype in ("float32", "bfloat16"):
        model = build_model("uno_s256", dtype=dtype,
                            generator=torch.Generator().manual_seed(0), **kw)
        rng = np.random.default_rng(0)
        xx = torch.from_numpy(rng.standard_normal((1, 256, 256, T_IN)).astype(np.float32))
        yy = torch.from_numpy(rng.standard_normal((1, 256, 256, 2)).astype(np.float32))
        loss, pred = make_rollout(model, 2)(xx, yy)
        loss.backward()
        assert pred.shape == (1, 256, 256, 2) and pred.dtype == torch.float32
        assert torch.isfinite(loss) and all(torch.isfinite(p.grad).all()
                                            for p in model.parameters())


def _tiny_preset(monkeypatch, **over):
    """ns2d at width 8 and T_f = 3, registered for the CLI as ``ns2d_tiny``."""
    p = dataclasses.replace(presets.PRESETS["ns2d"], name="ns2d_tiny",
                            model_kwargs=dict(KW), t_f=T_F, **over)
    monkeypatch.setitem(presets.PRESETS, "ns2d_tiny", p)
    return p


def test_cli_predict_ns2d_rolls_out_the_test_split(tmp_path, monkeypatch, capsys):
    """``cli predict`` on an NS cache: the rollout with zero targets, the
    batch's times, the trajectory equal to ``make_rollout``'s."""
    p = _tiny_preset(monkeypatch)
    a, u = _ns_data(3, seed=5)
    data, out = str(tmp_path / "ns.npz"), str(tmp_path / "pred.npz")
    empty_a, empty_u = a[:0], u[:0]
    np.savez(data, train_a=empty_a, train_u=empty_u, val_a=empty_a, val_u=empty_u,
             test_a=a, test_u=u, config_sig=np.asarray(cli._gen_sig(
                 dataclasses.replace(p, ntrain=0, nval=0, ntest=3))))
    assert cli.main(["predict", "--preset", "ns2d_tiny", "--data-cache", data, "--ntrain", "0",
                     "--nval", "0", "--ntest", "3", "--batch-size", "2", "--init-seed", "7",
                     "--out", out, "--device", "cpu"]) == 0
    report = [json.loads(line) for line in capsys.readouterr().out.splitlines()
              if line.startswith("{")][-1]
    assert report["n"] == 3 and len(report["batch_ms"]) == 2
    z = np.load(out)
    model = build_model("uno", generator=torch.Generator().manual_seed(7), **KW)
    with torch.no_grad():
        want = make_rollout(model, T_F)(torch.from_numpy(a), torch.zeros(3, S, S, T_F))[1]
    assert z["pred"].shape == (3, S, S, T_F)
    np.testing.assert_allclose(z["pred"], want.numpy(), rtol=0, atol=1e-5)
    assert np.array_equal(z["target"], u)


def test_cli_refuses_presets_not_ported(tmp_path):
    """Every uno_tpu preset is ported since the NS-3D slice: a name that is
    not a preset is refused, and the refusal lists the port's presets."""
    with pytest.raises(SystemExit, match="not ported.*ns3d_t40"):
        cli.main(["train", "--preset", "ns3d_t80", "--generate", "--device", "cpu"])
