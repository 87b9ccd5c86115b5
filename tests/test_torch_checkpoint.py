"""Checkpoints, resume, and the CLI's checkpoint and data paths of the port.

* ``CheckpointManager`` round-trips params and ComplexAdam state under
  ``torch.load(weights_only=True)``, and a save cut short before its
  ``os.replace`` leaves the previous checkpoint loadable;
* a run stopped by SIGTERM after epoch 1 and then resumed gives the same
  logs and parameters as ``uno_tpu``'s stop and resume (tiny uno9, f32):
  rel 1e-4 on each logged rel-L2, rel-L2 <= 1e-4 per parameter leaf.
  Resumed runs of both packages redraw epoch 0's batch order
  (``default_rng(cfg.seed)`` restarts);
* ``cli train --generate --data-cache`` writes a split cache that
  ``uno_tpu``'s ``_cached`` loads under its own signature, and the reverse;
  ``cli predict --checkpoint-dir`` and ``cli eval --checkpoint-dir`` serve
  the best params; ``cli generate --task darcy`` writes a readable ``.mat``.
"""

import argparse
import dataclasses
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from tests.test_torch_train import KW, _darcy_data, _flat_tree, _JRecords, _port_model, _Records, _rel
from uno_tpu import cli as jcli
from uno_tpu.configs.presets import get_preset as j_get_preset
from uno_tpu.models import build_model as jax_build_model
from uno_tpu.train import TrainConfig as JTrainConfig
from uno_tpu.train import train_darcy as j_train_darcy
from uno_tpu_torch import bridge, cli
from uno_tpu_torch.models import build_model
from uno_tpu_torch.optim import ComplexAdam
from uno_tpu_torch.train import checkpoint as ckpt_mod
from uno_tpu_torch.train.checkpoint import CheckpointManager
from uno_tpu_torch.train.common import TrainConfig
from uno_tpu_torch.train.darcy import train_darcy


def _stepped(seed=0):
    """A tiny model and a ComplexAdam that has taken two steps."""
    model = build_model("uno9", generator=torch.Generator().manual_seed(seed), **KW)
    opt = ComplexAdam(model.parameters(), lr=1e-3, weight_decay=1e-4)
    x = torch.from_numpy(_darcy_data(1, 85)[0])
    for _ in range(2):
        opt.zero_grad()
        model(x).square().mean().backward()
        opt.step()
    return model, opt, x


def test_params_and_adam_state_round_trip(tmp_path):
    model, opt, x = _stepped()
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save("train_state", {"params": model.state_dict(), "optimizer": opt.state_dict()["state"],
                             "step": 2, "epoch": 0, "best_val": float("inf")})
    assert mgr.exists("train_state") and not mgr.exists("best_params")
    got = mgr.restore("train_state")
    assert (got["step"], got["epoch"], got["best_val"]) == (2, 0, float("inf"))
    m2 = build_model("uno9", generator=torch.Generator().manual_seed(9), **KW)
    m2.load_state_dict(got["params"])
    o2 = ComplexAdam(m2.parameters(), lr=1e-3, weight_decay=1e-4)
    o2.load_state_dict({"state": got["optimizer"],
                        "param_groups": o2.state_dict()["param_groups"]})
    sa, sb = opt.state_dict()["state"], o2.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k]["step"] == sb[k]["step"] == 2
        for key in ("exp_avg", "exp_avg_sq"):
            assert sa[k][key].dtype == sb[k][key].dtype
            assert torch.equal(sa[k][key], sb[k][key])
    # one more step from each gives the same parameters
    for m, o in ((model, opt), (m2, o2)):
        o.zero_grad()
        m(x).square().mean().backward()
        o.step()
    for (n, p1), (_, p2) in zip(model.named_parameters(), m2.named_parameters()):
        assert torch.equal(p1, p2), n


def test_an_interrupted_save_leaves_the_previous_checkpoint(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save("best_params", {"w": torch.ones(3)})

    def killed(*args):
        raise KeyboardInterrupt("killed before the rename")

    monkeypatch.setattr(ckpt_mod.os, "replace", killed)
    with pytest.raises(KeyboardInterrupt):
        mgr.save("best_params", {"w": torch.zeros(3)})
    monkeypatch.undo()
    assert os.path.exists(mgr._path("best_params") + ".tmp")
    assert torch.equal(mgr.restore("best_params")["w"], torch.ones(3))

    class Unpicklable:  # the write itself fails halfway
        def __reduce__(self):
            raise RuntimeError("half written")

    with pytest.raises(RuntimeError):
        mgr.save("best_params", {"a": torch.zeros(1000), "b": Unpicklable()})
    assert torch.equal(mgr.restore("best_params")["w"], torch.ones(3))
    # the next complete save replaces it
    mgr.save("best_params", {"w": torch.zeros(3)})
    assert torch.equal(mgr.restore("best_params")["w"], torch.zeros(3))


def test_restore_is_weights_only(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save("x", {"v": np.float64(1.0)})  # a numpy scalar is not a plain type
    with pytest.raises(Exception, match="weights_only|Unsupported|global"):
        mgr.restore("x")
    with pytest.raises(FileNotFoundError):
        mgr.restore("missing")


class _SigTermAfterEpoch:
    """Mixin: SIGTERM to this process once epoch ``at`` is logged."""

    def __init__(self, at):
        super().__init__()
        self.at = at

    def log(self, record):
        super().log(record)
        if record.get("epoch") == self.at:
            os.kill(os.getpid(), signal.SIGTERM)


class _Stop(_SigTermAfterEpoch, _Records):
    pass


class _JStop(_SigTermAfterEpoch, _JRecords):
    pass


def test_stop_and_resume_match_uno_tpu(tmp_path):
    x, y = _darcy_data(16, 85)
    xv, yv = _darcy_data(8, 85, seed=1)
    kw = dict(epochs=3, batch_size=8, learning_rate=1e-3, weight_decay=1e-3, seed=0,
              checkpoint_every=0)  # only the stop's save writes train_state
    jm = jax_build_model("uno9", **KW)
    tree = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x[:1])))
    jck, tck = str(tmp_path / "jck"), str(tmp_path / "tck")
    legs = []
    for resume in (False, True):
        jrec = _JStop(at=1) if not resume else _JRecords()
        jout = j_train_darcy(jm, x, y, xv, yv, xv, yv,
                             JTrainConfig(checkpoint_dir=jck, resume=resume, **kw), logger=jrec)
        trec = _Stop(at=1) if not resume else _Records()
        model = _port_model(tree)  # the resumed leg's init is overwritten by the restore
        tout = train_darcy(model, x, y, xv, yv, xv, yv,
                           TrainConfig(checkpoint_dir=tck, resume=resume, **kw), logger=trec)
        legs.append((jrec.records, jout, trec.records, tout))

    (j1, jo1, t1, to1), (j2, jo2, t2, to2) = legs
    assert jo1["stopped_early"] and to1["stopped_early"]
    assert not jo2["stopped_early"] and not to2["stopped_early"]
    for jr, tr, epochs in ((j1, t1, [0, 1]), (j2, t2, [2])):
        je = [r for r in jr if "epoch" in r]
        te = [r for r in tr if "epoch" in r]
        assert [r["epoch"] for r in te] == [r["epoch"] for r in je] == epochs
        for a, b in zip(te, je):
            assert (a["step"], a["saved"]) == (b["step"], b["saved"])
            assert a["lr"] == pytest.approx(b["lr"], rel=1e-12)
            for k in ("train_rel_l2", "val_rel_l2"):
                assert a[k] == pytest.approx(b[k], rel=1e-4), (k, a[k], b[k])
    assert to2["test_rel_l2"] == pytest.approx(jo2["test_rel_l2"], rel=1e-4)
    assert to2["step"] == 6
    got = _flat_tree(bridge.params_to_flax(_loaded(tree, to2["params"])))
    want = _flat_tree(jo2["params"])
    for path, w in want.items():
        assert _rel(got[path], w) <= 1e-4, (path, _rel(got[path], w))
    # both saved the best params of the first leg
    assert CheckpointManager(tck).exists("best_params")


def _loaded(tree, state):
    model = _port_model(tree)
    model.load_state_dict(state)
    return model


def _port_split(path, ntrain=2, nval=1, ntest=2):
    return ["--preset", "darcy_s85", "--data-cache", path, "--ntrain", str(ntrain),
            "--nval", str(nval), "--ntest", str(ntest), "--batch-size", "2",
            "--device", "cpu"]


def test_generated_cache_loads_in_uno_tpu_and_back(tmp_path, capsys):
    path = str(tmp_path / "gen.npz")
    data = cli._load_data(argparse.Namespace(generate=True, data_cache=path, data=None,
                                             gen_dt=None, gen_T=None),
                          _preset(2, 1, 2), torch.device("cpu"))
    assert data[0].shape == (2, 85, 85, 1) and data[1].shape == (2, 85, 85)
    assert set(np.unique(data[0])) == {4.0, 12.0}
    jpreset = _jpreset(2, 1, 2)
    jdata = jcli._cached(path, lambda: pytest.fail("regenerated"), sig=jcli._gen_sig(jpreset, None))
    for a, b in zip(data, jdata):
        assert np.array_equal(a, b)
    # the reverse: a cache uno_tpu writes, read by the port's cli
    path2 = str(tmp_path / "jax.npz")
    fake = []
    for i, n in enumerate((2, 2, 1, 1, 2, 2)):  # (a, u) of train, val, test
        shape = (n, 85, 85, 1) if i % 2 == 0 else (n, 85, 85)
        fake.append(np.full(shape, i, np.float32))
    jcli._cached(path2, lambda: fake, sig=jcli._gen_sig(jpreset, None))
    got = cli._cached(path2, None, cli._gen_sig(_preset(2, 1, 2)))
    for a, b in zip(got, fake):
        assert np.array_equal(a, b)
    # another split size is another signature
    with pytest.raises(SystemExit, match="different config"):
        cli._cached(path2, None, cli._gen_sig(_preset(3, 1, 2)))


def _preset(ntrain, nval, ntest):
    from uno_tpu_torch.configs.presets import get_preset

    return dataclasses.replace(get_preset("darcy_s85"), ntrain=ntrain, nval=nval, ntest=ntest)


def _jpreset(ntrain, nval, ntest):
    return dataclasses.replace(j_get_preset("darcy_s85"), ntrain=ntrain, nval=nval, ntest=ntest)


def _json_lines(capsys):
    return [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]


def test_cli_train_checkpoint_resume_predict_eval(tmp_path, capsys):
    data, ck = str(tmp_path / "d.npz"), str(tmp_path / "ck")
    args = ["train", *_port_split(data), "--generate", "--checkpoint-dir", ck,
            "--weight-decay", "0"]
    assert cli.main(args + ["--epochs", "2"]) == 0
    first = _json_lines(capsys)
    assert [r["epoch"] for r in first if "epoch" in r] == [0, 1]
    assert os.path.exists(data)
    state = CheckpointManager(ck).restore("train_state")
    assert (state["epoch"], state["step"]) == (1, 2)
    # resume: loads the cache (no --generate needed) and logs epoch 2 first
    resume = ["train", *_port_split(data), "--checkpoint-dir", ck, "--resume",
              "--weight-decay", "0", "--epochs", "3"]
    assert cli.main(resume) == 0
    second = _json_lines(capsys)
    assert [r["epoch"] for r in second if "epoch" in r] == [2]
    assert second[0]["step"] == 3 and np.isfinite(second[-1]["test_rel_l2"])

    out = str(tmp_path / "p.npz")
    assert cli.main(["predict", *_port_split(data), "--checkpoint-dir", ck, "--out", out]) == 0
    report = _json_lines(capsys)[-1]
    assert report["spectral"] == "fft" and report["allow_bf16_reduced_precision_reduction"] is False
    z = np.load(out)
    best = CheckpointManager(ck).restore("best_params")
    model = build_model("uno9", generator=torch.Generator().manual_seed(0),
                        **_preset(2, 1, 2).model_kwargs)
    model.load_state_dict(best)
    with torch.no_grad():
        want = model(torch.from_numpy(z["input"])).numpy()[..., 0]
    np.testing.assert_allclose(z["pred"], want, rtol=0, atol=1e-5)

    assert cli.main(["eval", *_port_split(data), "--checkpoint-dir", ck]) == 0
    ev = _json_lines(capsys)[-1]
    assert set(ev) >= {"val_rel_l2", "test_rel_l2", "checkpoint"}
    from uno_tpu_torch.train.evaluate import evaluate_darcy

    assert ev["test_rel_l2"] == pytest.approx(
        evaluate_darcy(model, z["input"], z["target"], 2), rel=1e-6)


def test_cli_data_and_checkpoint_errors(tmp_path):
    data = str(tmp_path / "missing.npz")
    with pytest.raises(SystemExit, match="--generate"):
        cli.main(["train", *_port_split(data), "--epochs", "1"])
    with pytest.raises(SystemExit, match="--data-cache"):
        cli.main(["train", "--preset", "darcy_s85", "--device", "cpu"])
    with pytest.raises(SystemExit, match="best_params"):
        cli.main(["eval", *_port_split(data), "--generate",
                  "--checkpoint-dir", str(tmp_path / "empty")])
    with pytest.raises(SystemExit, match="checkpoint-dir"):
        cli.main(["train", *_port_split(data), "--generate", "--resume"])


def test_cli_generate_writes_a_mat_file(tmp_path, capsys):
    out = str(tmp_path / "darcy.mat")
    assert cli.main(["generate", "--task", "darcy", "--out", out, "--n", "2", "--size", "17",
                     "--seed", "1", "--device", "cpu"]) == 0
    m = scipy.io.loadmat(out)
    assert m["coeff"].shape == m["sol"].shape == (2, 17, 17)
    assert set(np.unique(m["coeff"])) == {4.0, 12.0} and np.isfinite(m["sol"]).all()
    # --task ns is ported: one batch of trajectories, 4 steps in 2 records
    assert cli.main(["generate", "--task", "ns", "--out", out, "--n", "2", "--size", "16",
                     "--T", "0.04", "--delta-t", "0.01", "--record-steps", "2",
                     "--device", "cpu"]) == 0
    m = scipy.io.loadmat(out)
    assert m["a0"].shape == (2, 16, 16) and m["u0"].shape == (2, 16, 16, 2)
    assert np.isfinite(m["u0"]).all()
