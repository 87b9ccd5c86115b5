"""Channel tensor parallelism in the port (``parallel/tp.py``, the TP forms
of the layers, the trainers with ``cfg.tensor_parallel``) against
``uno_tpu``'s ``tp_spec``, its replicated step and its TP trainer, on the
CPU.

Two ranks run as two processes joined over gloo; this file is their script
(``_rank_main``).  They run every case once and save what they saw, while
this process runs ``uno_tpu``'s side.  ``uno_tpu`` runs TP on its
partial-DFT path (XLA CPU's FFT thunk rejects the weight-sharded layouts,
``tests/test_tensor_parallel.py:80-88``); the port keeps its FFT path under
TP and is held to it on both of its paths.

Bounds: one TP step of uno9 (width 8, s = 88) against ``uno_tpu``'s
replicated DFT step, the loss within rtol 1e-5 and the weights within atol
1e-5 / rtol 1e-4 (``tests/test_tensor_parallel.py:94-104``); ``train_darcy``
against ``uno_tpu``'s under ``make_mesh(n_data=1, n_spatial=2)``,
``tests/test_torch_parallel.py``'s bounds; checkpoints across the two
layouts, the same bounds.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import (
    DARCY_CFG,
    DARCY_KW,
    ENV_KEYS,
    REPO,
    _flat_tree,
    _free_port,
    _List,
    _port_model,
    _rel,
    _splits,
)
from uno_tpu_torch import bridge
from uno_tpu_torch.losses import relative_lp_loss
from uno_tpu_torch.models import build_model, core
from uno_tpu_torch.ops import spectral
from uno_tpu_torch.ops.kernels import mlp_head
from uno_tpu_torch.optim import ComplexAdam, step_lr
from uno_tpu_torch.parallel import dp_value_and_grad, make_mesh, place_state, tp_spec
from uno_tpu_torch.parallel.tp import full_state
from uno_tpu_torch.train.checkpoint import CheckpointManager
from uno_tpu_torch.train.common import TrainConfig, sharded_params
from uno_tpu_torch.train.darcy import train_darcy

STEP_S, STEP_KW = 88, dict(in_width=3, width=8, pad=1)  # tests/test_tensor_parallel.py:38-40
# the checkpoint runs: the batch divides the split, so one process and the
# ranks (which drop a remainder batch) take the same steps
CK_CFG = dict(DARCY_CFG, epochs=2, checkpoint_every=1, drop_remainder=True)


def _tx():
    """``tests/test_tensor_parallel.py``'s optimizer."""
    return dict(lr=step_lr(1e-3, 100, 0.5, 10), weight_decay=1e-3)


def _step(model, dp, x, y):
    """One step of ``tests/test_tensor_parallel.py``'s: the loss and the
    whole weights."""
    opt = ComplexAdam(model.parameters(), **_tx())

    def loss_fn(x, y):
        return relative_lp_loss(model(x).reshape(y.shape), y, reduction="sum")

    loss, _ = dp_value_and_grad(loss_fn, dp, model.parameters(),
                                sharded=sharded_params(model))(x, y)
    opt.step()
    return float(loss), full_state(model, dp, {k: v.detach().clone()
                                               for k, v in model.state_dict().items()})


# ---------------------------------------------------------------- the ranks

def _rank_main(out_dir: str) -> None:
    from uno_tpu_torch.parallel import initialize_from_env

    assert initialize_from_env("gloo")
    dp = make_mesh(n_data=1, n_spatial=2, device="cpu")
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    res = {}
    x, y = (torch.from_numpy(a) for a in inputs["step"])
    for path, dft in (("fft", False), ("dft", True)):
        spectral.set_dft_mode(dft)
        try:
            model = place_state(dp, _port_model("uno9", STEP_KW, inputs["init"]["step"]),
                                tensor_parallel=True)
            res[f"step_{path}"] = _step(model, dp, x, y)
        finally:
            spectral.set_dft_mode(None)
    res["shapes"] = {n: tuple(p.shape) for n, p in model.named_parameters()}

    # the fused head stays off under TP whatever the switch says
    calls = []
    real = core.mlp_head
    core.mlp_head = lambda *a: calls.append(1) or real(*a)
    mlp_head.set_fused_head_mode(True)
    try:
        model = place_state(dp, build_model("uno9", dtype="bfloat16",
                                            generator=torch.Generator().manual_seed(0),
                                            **STEP_KW), tensor_parallel=True)
        with torch.no_grad():
            res["head"] = dict(calls=len(calls), out=model(x[:2]))
    finally:
        core.mlp_head = real
        mlp_head.set_fused_head_mode(None)

    model = _port_model("uno9", DARCY_KW, inputs["init"]["darcy"])
    logger = _List()
    train_darcy(model, *inputs["splits"]["darcy"],
                TrainConfig(**DARCY_CFG, tensor_parallel=True), logger=logger, dp=dp)
    res["darcy"] = dict(records=logger.records,
                        state=full_state(model, dp, model.state_dict()))

    # checkpoints: a TP run writes one; a TP run resumes a one-process one
    model = _port_model("uno9", DARCY_KW, inputs["init"]["darcy"])
    train_darcy(model, *inputs["splits"]["darcy"],
                TrainConfig(**CK_CFG, tensor_parallel=True,
                            checkpoint_dir=os.path.join(out_dir, "ck_tp")),
                logger=_List(), dp=dp)
    model = _port_model("uno9", DARCY_KW, inputs["init"]["darcy"])
    train_darcy(model, *inputs["splits"]["darcy"],
                TrainConfig(**dict(CK_CFG, epochs=3), tensor_parallel=True, resume=True,
                            checkpoint_dir=os.path.join(out_dir, f"ck_one_{dp.spatial.rank}")),
                logger=_List(), dp=dp)
    res["resumed"] = full_state(model, dp, model.state_dict())
    torch.save(res, os.path.join(out_dir, f"rank{dp.spatial.rank}.pt"))


# ------------------------------------------------------------ uno_tpu's side

def _jax_side(step, step_tree, splits, darcy_tree):
    """uno_tpu's replicated DFT step and its TP trainer (on the DFT path)."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from tests.test_torch_ns3d import _FixedInit
    from tests.test_torch_train import _JRecords
    from uno_tpu.losses import relative_lp_loss as j_loss
    from uno_tpu.models import build_model as jax_build_model
    from uno_tpu.ops import spectral as jspectral
    from uno_tpu.optim import complex_adam
    from uno_tpu.optim import step_lr as j_step_lr
    from uno_tpu.parallel import make_mesh as jax_make_mesh
    from uno_tpu.train import TrainConfig as JTrainConfig
    from uno_tpu.train import train_darcy as j_train_darcy
    from uno_tpu.train.state import TrainState, apply_updates

    jm = jax_build_model("uno9", **STEP_KW)
    tx = complex_adam(j_step_lr(1e-3, 100, 0.5, 10), weight_decay=1e-3)
    x, y = (jnp.asarray(a) for a in step)

    def loss_fn(p, x, y):
        return j_loss(jm.apply(p, x).reshape(y.shape[0], STEP_S, STEP_S), y, reduction="sum")

    @partial(jax.jit)
    def train_step(state, x, y):
        loss, grads = jax.value_and_grad(loss_fn)(state.params, x, y)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        return TrainState(params=apply_updates(state.params, updates), opt_state=opt_state,
                          step=state.step + 1), loss

    jspectral.set_dft_mode(True)
    jax.clear_caches()
    try:
        state, loss = train_step(TrainState.create(jax.tree.map(jnp.asarray, step_tree), tx),
                                 x, y)
        out = {"step": (float(loss), jax.tree.map(np.asarray, jax.device_get(state.params)))}
        rec = _JRecords()
        jdm = _FixedInit(jax_build_model("uno9", **DARCY_KW),
                         jax.tree.map(jnp.asarray, darcy_tree))
        res = j_train_darcy(jdm, *splits["darcy"], JTrainConfig(**DARCY_CFG,
                                                                tensor_parallel=True),
                            mesh=jax_make_mesh(n_data=1, n_spatial=2), logger=rec)
        out["darcy"] = (rec.records, res)
    finally:
        jspectral.set_dft_mode(None)
        jax.clear_caches()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from uno_tpu.models import build_model as jax_build_model

    out_dir = str(tmp_path_factory.mktemp("tp"))
    splits = _splits()
    rng = np.random.default_rng(1)  # tests/test_tensor_parallel.py's inputs
    step = (rng.standard_normal((4, STEP_S, STEP_S, 1)).astype(np.float32),
            rng.standard_normal((4, STEP_S, STEP_S)).astype(np.float32))
    step_tree = jax.tree.map(np.asarray, jax.jit(jax_build_model("uno9", **STEP_KW).init)(
        jax.random.PRNGKey(0), jnp.asarray(step[0])))
    init = {"step": bridge.params_from_flax(_port_model("uno9", STEP_KW), step_tree)
            .state_dict(), "darcy": _port_model("uno9", DARCY_KW).state_dict()}
    darcy_tree = bridge.params_to_flax(_port_model("uno9", DARCY_KW, init["darcy"]))
    torch.save({"splits": splits, "init": init, "step": step},
               os.path.join(out_dir, "inputs.pt"))

    # a one-process checkpoint for the ranks to resume, one copy a rank
    one = _port_model("uno9", DARCY_KW, init["darcy"])
    train_darcy(one, *splits["darcy"], TrainConfig(**CK_CFG,
                                                   checkpoint_dir=os.path.join(out_dir, "ck_one")),
                logger=_List())
    for r in range(2):
        shutil.copytree(os.path.join(out_dir, "ck_one"), os.path.join(out_dir, f"ck_one_{r}"))

    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    env.update(PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2", OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), out_dir],
                              env=dict(env, RANK=str(r)), cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        jax_out = _jax_side(step, step_tree, splits, darcy_tree)
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    return dict(ranks=ranks, jax=jax_out, out_dir=out_dir, splits=splits, init=init,
                step=step)


@pytest.mark.parametrize("name,kw", [
    ("uno9", dict(in_width=3, width=8, pad=1)),
    ("uno9", dict(in_width=3, width=6, pad=1)),
    ("uno", dict(in_width=14, width=8, pad=0)),
    ("uno3d_t10", dict(in_width=6, width=4, pad=2)),
])
@pytest.mark.parametrize("n_tp", [2, 4])
def test_tp_spec_shards_the_same_logical_axis_as_uno_tpus(name, kw, n_tp):
    import jax

    from uno_tpu.parallel import tp_spec as j_tp_spec

    model = build_model(name, generator=torch.Generator().manual_seed(0), **kw)
    tree = bridge.params_to_flax(model)["params"]
    leaves = {tuple(k.key for k in kp): (kp, leaf)
              for kp, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    sharded = 0
    for pname, p in model.named_parameters():
        path, transposed = bridge._flax_path(pname)
        kp, leaf = leaves[path]
        spec = tuple(j_tp_spec(kp, leaf, n_tp))
        want = spec.index("spatial") if "spatial" in spec else None
        got = tp_spec(pname, tuple(p.shape), n_tp)
        if transposed and got is not None:
            got = p.ndim - 1 - got  # (out, in) -> flax's (in, out)
        assert got == want, (pname, got, want)
        sharded += got is not None
    assert sharded  # some axes divide
    # the out_dim = 1 projection stays replicated
    assert tp_spec("fc2.weight", tuple(model.fc2.weight.shape), n_tp) is None


@pytest.mark.parametrize("path", ["fft", "dft"])
def test_tp_step_matches_uno_tpus_replicated_dft_step(runs, path):
    want_loss, want_tree = runs["jax"]["step"]
    want = _flat_tree(want_tree)
    for r in runs["ranks"]:
        loss, state = r[f"step_{path}"]
        assert loss == pytest.approx(want_loss, rel=1e-5)
        got = _flat_tree(bridge.params_to_flax(_port_model("uno9", STEP_KW, state)))
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, atol=1e-5, rtol=1e-4, err_msg=str(k))
    # the FFT and DFT paths agree (uno_tpu's cross-check, rtol 1e-4)
    assert runs["ranks"][0]["step_fft"][0] == pytest.approx(runs["ranks"][0]["step_dft"][0],
                                                            rel=1e-4)


def test_each_rank_holds_its_shards(runs):
    shapes = runs["ranks"][0]["shapes"]
    full = dict(_port_model("uno9", STEP_KW).named_parameters())
    assert shapes["block1.conv.weights"][2] * 2 == full["block1.conv.weights"].shape[2]
    assert shapes["fc1.weight"][0] * 2 == full["fc1.weight"].shape[0]
    assert shapes["fc2.weight"] == tuple(full["fc2.weight"].shape)  # out_dim 1: replicated
    assert runs["ranks"][1]["shapes"] == shapes


def test_fused_head_stays_off_under_tp(runs):
    """fc1's hidden axis is sharded: the model takes the unfused f32 Dense
    pair whatever the switch says, and its output is the one-process
    model's with the switch off."""
    model = build_model("uno9", dtype="bfloat16", generator=torch.Generator().manual_seed(0),
                        **STEP_KW)
    mlp_head.set_fused_head_mode(False)
    try:
        with torch.no_grad():
            want = model(torch.from_numpy(runs["step"][0][:2]))
    finally:
        mlp_head.set_fused_head_mode(None)
    for r in runs["ranks"]:
        assert r["head"]["calls"] == 0
        rel = float((r["head"]["out"] - want).norm() / want.norm())
        assert rel < 2e-2, rel  # bf16 activations, rounded after sums in another order


def test_tp_training_matches_uno_tpus_tp_trainer(runs):
    r0, r1 = (r["darcy"] for r in runs["ranks"])
    jrecords, jout = runs["jax"]["darcy"]
    assert r1["records"] == []
    tr = [r for r in r0["records"] if "epoch" in r]
    jr = [r for r in jrecords if "epoch" in r]
    assert len(tr) == len(jr) == DARCY_CFG["epochs"]
    for a, b in zip(tr, jr):
        assert (a["epoch"], a["step"], a["saved"]) == (b["epoch"], b["step"], b["saved"])
        for k in ("train_rel_l2", "val_rel_l2"):
            assert a[k] == pytest.approx(b[k], rel=1e-3), (k, a[k], b[k])
    assert all(torch.equal(r0["state"][k], r1["state"][k]) for k in r0["state"])
    got = _flat_tree(bridge.params_to_flax(_port_model("uno9", DARCY_KW, r0["state"])))
    for path, w in _flat_tree(jout["params"]).items():
        assert _rel(got[path], w) <= 1e-3, (path, _rel(got[path], w))


def test_tp_checkpoint_is_a_one_process_checkpoint(runs):
    """Rank 0 of a TP run writes whole tensors in a one-process run's
    layout; a one-process run resumes it, and TP ranks resume a
    one-process checkpoint, to the same weights as one process resuming
    it."""
    out_dir, splits, init = runs["out_dir"], runs["splits"], runs["init"]
    tp = CheckpointManager(os.path.join(out_dir, "ck_tp")).restore("train_state")
    one = CheckpointManager(os.path.join(out_dir, "ck_one")).restore("train_state")
    assert tp.keys() == one.keys() and tp["params"].keys() == one["params"].keys()
    for k, v in one["params"].items():
        assert tp["params"][k].shape == v.shape and tp["params"][k].dtype == v.dtype
        assert _rel(tp["params"][k].numpy(), v.numpy()) <= 1e-3, k
    assert tp["optimizer"].keys() == one["optimizer"].keys()
    for i, st in one["optimizer"].items():
        assert tp["optimizer"][i]["step"] == st["step"]
        for k in ("exp_avg", "exp_avg_sq"):
            assert tp["optimizer"][i][k].shape == st[k].shape
    assert (tp["step"], tp["epoch"]) == (one["step"], one["epoch"])
    best = CheckpointManager(os.path.join(out_dir, "ck_tp")).restore("best_params")
    assert best.keys() == one["params"].keys()

    def resume(ck):
        model = _port_model("uno9", DARCY_KW, init["darcy"])
        shutil.copytree(os.path.join(out_dir, ck), os.path.join(out_dir, ck + "_again"))
        train_darcy(model, *splits["darcy"],
                    TrainConfig(**dict(CK_CFG, epochs=3), resume=True,
                                checkpoint_dir=os.path.join(out_dir, ck + "_again")),
                    logger=_List())
        return model.state_dict()

    want = resume("ck_one")
    for got in (resume("ck_tp"), runs["ranks"][0]["resumed"], runs["ranks"][1]["resumed"]):
        for k, v in want.items():
            a, b = (torch.view_as_real(t) if t.is_complex() else t for t in (got[k], v))
            assert _rel(a.numpy(), b.numpy()) <= 1e-3, k


def test_cli_train_tensor_parallel_over_two_processes(tmp_path, capsys):
    """``cli train --tensor-parallel 2 --device cpu`` as two ranks over
    gloo: rank 0 alone prints, with the fused head off; the losses are the
    one-process run's."""
    from tests.test_torch_train import _split_cache
    from uno_tpu_torch import cli

    data, ck = str(tmp_path / "d.npz"), str(tmp_path / "ck")
    _split_cache(data, ntrain=2, nval=2, ntest=2)
    argv = ["train", "--preset", "darcy_s85", "--data-cache", data, "--ntrain", "2", "--nval",
            "2", "--ntest", "2", "--epochs", "1", "--batch-size", "2", "--device", "cpu"]
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    env.update(PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2", OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-m", "uno_tpu_torch.cli", *argv,
                               "--tensor-parallel", "2", "--checkpoint-dir", ck],
                              env=dict(env, RANK=str(r)), cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    lines = [[json.loads(l) for l in o.splitlines() if l.startswith("{")] for o in outs]
    assert lines[1] == [] and len(lines[0]) == 2
    assert '"fused_head": false' in outs[0]
    params = CheckpointManager(ck).restore("best_params")
    model = build_model("uno9", in_width=3, width=32, pad=5)
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}

    assert cli.main(argv) == 0
    single = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    for k in ("train_rel_l2", "val_rel_l2"):
        assert lines[0][0][k] == pytest.approx(single[0][k], rel=1e-5)


if __name__ == "__main__":
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "2")))
    _rank_main(sys.argv[1])
    torch.distributed.destroy_process_group()
