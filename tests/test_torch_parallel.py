"""Data parallelism of the port (``uno_tpu_torch.parallel`` and the
trainers' ``dp``) against ``uno_tpu``'s mesh path, on the CPU.

Two ranks run as two processes joined over gloo; this file is their script
(``_rank_main``).  They train the Darcy, NS-2D and NS-3D models, compute one
``dp_value_and_grad``, and stop together when one rank is signalled, while
this process runs ``uno_tpu``'s trainers under ``make_mesh(n_data=2)`` on two
of the conftest's virtual CPU devices, from the same weights: ``uno_tpu``'s
init from ``PRNGKey(cfg.seed)`` carried into the port by the bridge for the
2-D models; for the 3-D one the port's init carried into flax, because a
flax init of a 3-D model compiles for ~15 s (tests/test_torch_ns3d.py).

Bounds (tests/test_torch_train.py's): each epoch's train and val loss
within rel 1e-3 of ``uno_tpu``'s, the logged lr within rel 1e-12, the final
weights rel-L2 <= 1e-3 per leaf; the ranks' weights equal bit for bit;
``dp_value_and_grad``'s summed loss and gradients against one process's
over the whole batch at ``tests/test_shard_map.py``'s rtol 1e-5 and atol
2e-4.  The Darcy run is ``tests/test_train_dp.py``'s uneven split (19
train, 9 val, batch 8) with a test split of 5: the mesh path drops every
remainder batch, so 2 steps run per epoch while StepLR counts 3, val
averages 8 samples and test evaluates none (0.0).
"""

import json
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from uno_tpu_torch import bridge
from uno_tpu_torch.losses import relative_lp_loss
from uno_tpu_torch.models import build_model
from uno_tpu_torch.parallel import (
    dp_value_and_grad,
    initialize_from_env,
    local_rows,
    make_mesh,
)
from uno_tpu_torch.train.common import TrainConfig
from uno_tpu_torch.train.darcy import train_darcy
from uno_tpu_torch.train.metrics import MetricLogger
from uno_tpu_torch.train.ns2d import train_ns2d
from uno_tpu_torch.train.ns3d import train_ns3d
from uno_tpu_torch.utils import start_recording, stop_recording

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
DARCY_KW = dict(in_width=3, width=8, pad=1)           # uno9 at 85x85
NS2D_KW, NS2D_T_F = dict(in_width=14, width=8, pad=0), 3  # uno at 64x64, T_in 10
NS3D_KW, NS3D_T_F = dict(in_width=6, width=2, pad=2), 10  # uno3d_t10 at 32x32
DARCY_CFG = dict(epochs=3, batch_size=8, learning_rate=1e-3, weight_decay=1e-4, seed=0,
                 scheduler_step=1)
NS_CFG = dict(epochs=2, batch_size=2, learning_rate=1e-3, weight_decay=1e-5, seed=0)
GRAD_KW = dict(in_width=14, width=8, pad=0)           # tests/test_shard_map.py's uno
ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
            "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _darcy_data(n, s=85, seed=0):
    """tests/test_train.py's learnable target: a local average."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, s, s, 1)).astype(np.float32)
    y = (x[..., 0] + np.roll(x[..., 0], 1, 1) + np.roll(x[..., 0], 1, 2)) / 3.0
    return x, y.astype(np.float32)


def _ns_data(n, s, t_in, t_f, seed):
    """The last input frame plus small noise: a target a forecast can learn."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, s, s, t_in)).astype(np.float32)
    u = (0.1 * rng.standard_normal((n, s, s, t_f)) + a[..., -1:]).astype(np.float32)
    return a, u


def _splits():
    x, y = _darcy_data(19 + 9 + 5)
    a2, u2 = _ns_data(8, 64, 10, NS2D_T_F, seed=1)
    a3, u3 = _ns_data(8, 32, 10, NS3D_T_F, seed=2)
    ga, gu = _ns_data(4, 64, 10, 1, seed=3)
    return {
        "darcy": (x[:19], y[:19], x[19:28], y[19:28], x[28:], y[28:]),
        "ns2d": (a2[:4], u2[:4], a2[4:6], u2[4:6], a2[6:], u2[6:]),
        "ns3d": (a3[:4], u3[:4], a3[4:6], u3[4:6], a3[6:], u3[6:]),
        "grads": (ga, gu),
    }


def _port_model(name, kw, state=None):
    model = build_model(name, generator=torch.Generator().manual_seed(1), **kw)
    if state is not None:
        model.load_state_dict(state)
    return model


class _List(MetricLogger):
    def __init__(self):
        self.records = []

    def log(self, record):
        self.records.append(record)


def _grads_loss(model):
    def loss_fn(x, y):
        return relative_lp_loss(model(x), y, reduction="sum")
    return loss_fn


# ---------------------------------------------------------------- the ranks

def _rank_main(out_dir: str) -> None:
    """One rank: joins the group from the environment, runs every case and
    saves what it saw to ``out_dir/rank<r>.pt``."""
    assert initialize_from_env("gloo")
    dp = make_mesh(device="cpu")
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    splits, init = inputs["splits"], inputs["init"]
    res = {}
    for task, trainer, name, kw, extra in (
            ("darcy", train_darcy, "uno9", DARCY_KW, dict(cfg=DARCY_CFG)),
            ("ns2d", train_ns2d, "uno", NS2D_KW, dict(cfg=NS_CFG, t_f=NS2D_T_F)),
            ("ns3d", train_ns3d, "uno3d_t10", NS3D_KW, dict(cfg=NS_CFG, t_f=NS3D_T_F))):
        model = _port_model(name, kw, init[task])
        logger = _List()
        kwargs = {"t_f": extra["t_f"]} if "t_f" in extra else {}
        out = trainer(model, *splits[task], TrainConfig(**extra["cfg"]), logger=logger,
                      dp=dp, **kwargs)
        res[task] = dict(records=logger.records, out={k: v for k, v in out.items()
                                                      if k != "params"},
                         state=model.state_dict())

    # dp_value_and_grad: this rank's rows of a batch of 4
    model = _port_model("uno", GRAD_KW, init["grads"])
    x, y = (torch.from_numpy(t[local_rows(np.arange(4), dp.rank, dp.world)])
            for t in splits["grads"])
    loss, grads = dp_value_and_grad(_grads_loss(model), dp, model.parameters())(x, y)
    res["grads"] = dict(loss=loss, grads=[g.clone() for g in grads])

    # a stop requested on rank 1 alone, during epoch 0's first step
    model = _port_model("uno9", DARCY_KW, init["darcy"])
    if dp.rank == 1:
        def sigterm_once(module, args):
            handle.remove()
            os.kill(os.getpid(), signal.SIGTERM)
        handle = model.register_forward_pre_hook(sigterm_once)
    logger = _List()
    out = train_darcy(model, *splits["darcy"], TrainConfig(**DARCY_CFG), logger=logger, dp=dp)
    res["stop"] = dict(records=logger.records, stopped=out["stopped_early"], step=out["step"])
    torch.save(res, os.path.join(out_dir, f"rank{dp.rank}.pt"))


# ------------------------------------------------------------ uno_tpu's side

def _jax_trainers(splits, init_trees):
    """uno_tpu's three trainers under a 2-device data mesh, from the same
    weights: (records, result) per task."""
    import jax

    from tests.test_torch_ns3d import _FixedInit
    from tests.test_torch_train import _JRecords
    from uno_tpu.models import build_model as jax_build_model
    from uno_tpu.parallel import make_mesh as jax_make_mesh
    from uno_tpu.train import TrainConfig as JTrainConfig
    from uno_tpu.train import train_darcy as j_train_darcy
    from uno_tpu.train import train_ns2d as j_train_ns2d
    from uno_tpu.train import train_ns3d as j_train_ns3d

    mesh = jax_make_mesh(n_data=WORLD)
    out = {}
    for task, trainer, jm, cfg, kw in (
            ("darcy", j_train_darcy, jax_build_model("uno9", **DARCY_KW), DARCY_CFG, {}),
            ("ns2d", j_train_ns2d, jax_build_model("uno", **NS2D_KW), NS_CFG,
             dict(t_f=NS2D_T_F)),
            ("ns3d", j_train_ns3d,
             _FixedInit(jax_build_model("uno3d_t10", **NS3D_KW),
                        jax.tree.map(jax.numpy.asarray, init_trees["ns3d"])),
             NS_CFG, dict(t_f=NS3D_T_F))):
        rec = _JRecords()
        res = trainer(jm, *splits[task], JTrainConfig(**cfg), mesh=mesh, logger=rec, **kw)
        out[task] = (rec.records, res)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' results and uno_tpu's, computed once for the file;
    the ranks run while uno_tpu trains."""
    import jax
    import jax.numpy as jnp

    from uno_tpu.models import build_model as jax_build_model

    out_dir = str(tmp_path_factory.mktemp("dp"))
    splits = _splits()
    trees = {}
    for task, name, kw in (("darcy", "uno9", DARCY_KW), ("ns2d", "uno", NS2D_KW),
                           ("grads", "uno", GRAD_KW)):
        x0 = splits[task][0][:1]
        jm = jax_build_model(name, **kw)
        trees[task] = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0),
                                                               jnp.asarray(x0)))
    init = {task: bridge.params_from_flax(_port_model(name, kw), trees[task]).state_dict()
            for task, name, kw in (("darcy", "uno9", DARCY_KW), ("ns2d", "uno", NS2D_KW),
                                   ("grads", "uno", GRAD_KW))}
    init["ns3d"] = _port_model("uno3d_t10", NS3D_KW).state_dict()
    trees["ns3d"] = bridge.params_to_flax(_port_model("uno3d_t10", NS3D_KW, init["ns3d"]))
    torch.save({"splits": splits, "init": init}, os.path.join(out_dir, "inputs.pt"))

    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    env.update(PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(WORLD), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), out_dir],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        jax_out = _jax_trainers(splits, trees)
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return dict(ranks=ranks, jax=jax_out, splits=splits, init=init)


def _rel(a, b):
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _flat_tree(tree):
    from tests.test_torch_train import _flat_tree as flat

    return flat(tree)


LOSS_KEYS = {"darcy": ("train_rel_l2", "val_rel_l2"),
             "ns2d": ("train_step_rel_l2", "val_step_rel_l2", "val_traj_rel_l2"),
             "ns3d": ("train_step_rel_l2", "val_step_rel_l2", "val_full_rel_l2")}
MODELS = {"darcy": ("uno9", DARCY_KW), "ns2d": ("uno", NS2D_KW), "ns3d": ("uno3d_t10", NS3D_KW)}


@pytest.mark.parametrize("task", ["darcy", "ns2d", "ns3d"])
def test_two_rank_training_matches_uno_tpus_mesh(runs, task):
    r0, r1 = (r[task] for r in runs["ranks"])
    jrecords, jout = runs["jax"][task]
    assert r1["records"] == []  # only rank 0 logs
    tr = [r for r in r0["records"] if "epoch" in r]
    jr = [r for r in jrecords if "epoch" in r]
    assert len(tr) == len(jr) > 0
    for a, b in zip(tr, jr):
        assert set(a) - {"t"} == set(b) - {"t"} | {"step_ms"}
        assert (a["epoch"], a["step"], a.get("saved")) == (b["epoch"], b["step"], b.get("saved"))
        assert a["lr"] == pytest.approx(b["lr"], rel=1e-12)
        for k in LOSS_KEYS[task]:
            assert a[k] == pytest.approx(b[k], rel=1e-3), (k, a[k], b[k])
    tests = [(k, v) for k, v in r0["records"][-1].items() if k.startswith("test_")]
    assert tests and all(v == pytest.approx(jout[k], rel=1e-3, abs=1e-12) for k, v in tests)
    # the ranks hold the same weights, bit for bit
    assert r0["state"].keys() == r1["state"].keys()
    assert all(torch.equal(r0["state"][k], r1["state"][k]) for k in r0["state"])
    name, kw = MODELS[task]
    got = _flat_tree(bridge.params_to_flax(_port_model(name, kw, r0["state"])))
    want = _flat_tree(jout["params"])
    for path, w in want.items():
        assert _rel(got[path], w) <= 1e-3, (path, _rel(got[path], w))


def test_uneven_split_follows_the_mesh_paths_quirks(runs):
    """19 train, 9 val, 5 test at batch 8 over 2 ranks: 2 steps per epoch
    while StepLR counts 3 (uno_tpu/train/darcy.py:55), val on 8 samples,
    test on none (uno_tpu/train/darcy.py:69)."""
    records = runs["ranks"][0]["darcy"]["records"]
    jrecords = runs["jax"]["darcy"][0]
    epochs = [r for r in records if "epoch" in r]
    assert len(records) == len(jrecords) == 4
    assert [r["step"] for r in epochs] == [2, 4, 6]
    # counted 3 steps per epoch: step 6 is in the schedule's epoch 1, not 2
    assert [r["lr"] for r in epochs] == pytest.approx([1e-3, 5e-4, 5e-4], rel=1e-12)
    x_val, y_val = runs["splits"]["darcy"][2:4]
    assert records[-1] == {**records[-1], "task": "darcy", "test_rel_l2": 0.0}
    assert runs["jax"]["darcy"][1]["test_rel_l2"] == 0.0
    assert runs["ranks"][0]["darcy"]["out"]["step"] == 6
    assert len(x_val) == 9 and all(len(r["step_ms"]) == 2 for r in epochs)


def test_dp_value_and_grad_sums_to_the_one_process_gradient(runs):
    """tests/test_shard_map.py's check: each rank's loss and gradients on its
    half of the batch, summed over the ranks, against one process's on all of
    it."""
    model = _port_model("uno", GRAD_KW, runs["init"]["grads"])
    x, y = (torch.from_numpy(t) for t in runs["splits"]["grads"])
    loss, grads = dp_value_and_grad(_grads_loss(model), None, model.parameters())(x, y)
    for rank in runs["ranks"]:
        got = rank["grads"]
        assert float(got["loss"]) == pytest.approx(float(loss), rel=1e-5)
        assert len(got["grads"]) == len(grads)
        for g, w in zip(got["grads"], grads):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-4)
    assert all(torch.equal(a, b) for a, b in zip(runs["ranks"][0]["grads"]["grads"],
                                                  runs["ranks"][1]["grads"]["grads"]))


def test_a_stop_on_one_rank_stops_both(runs):
    """SIGTERM reaches rank 1 alone in epoch 0: both ranks finish the epoch
    and stop; rank 0, which logs, records the stop."""
    r0, r1 = (r["stop"] for r in runs["ranks"])
    assert r0["stopped"] and r1["stopped"] and r0["step"] == r1["step"] == 2
    assert [r["epoch"] for r in r0["records"] if "epoch" in r] == [0]
    assert r0["records"][-1] == {**r0["records"][-1], "stopped_early_after_epoch": 0}
    assert r1["records"] == []


@pytest.mark.parametrize("n", [2, 4, 8])
def test_local_rows_are_jaxs_batch_shards(n):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from uno_tpu.parallel import make_mesh as jax_make_mesh

    mesh = jax_make_mesh(n_data=n)
    for batch in (n, 2 * n, 24):
        idx = np.random.default_rng(n).permutation(100)[:batch]
        shards = NamedSharding(mesh, P("data")).devices_indices_map((batch,))
        for rank, device in enumerate(mesh.devices[:, 0]):
            np.testing.assert_array_equal(local_rows(idx, rank, n), idx[shards[device][0]])
    with pytest.raises(ValueError, match="evenly"):
        local_rows(np.arange(n + 1), 0, n)
    assert jax.device_count() >= n


def test_initialize_from_env_is_a_no_op_without_env(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    assert initialize_from_env("gloo") is False
    assert not torch.distributed.is_initialized()
    dp = make_mesh(device="cpu")
    assert (dp.group, dp.rank, dp.world, dp.device) == (None, 0, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(n_spatial=2, device="cpu")  # a 1 x 2 mesh in a single process
    with pytest.raises(ValueError, match="ranks"):
        make_mesh(n_data=2, device="cpu")


def test_initialize_from_env_reads_uno_tpus_spellings(monkeypatch):
    """COORDINATOR_ADDRESS, NUM_PROCESSES and PROCESS_ID (uno_tpu's
    ``distributed.py``) stand for MASTER_ADDR:MASTER_PORT, WORLD_SIZE and
    RANK; a group named without its rank raises."""
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("NUM_PROCESSES", "1")
    with pytest.raises(ValueError, match="rank"):
        initialize_from_env("gloo")
    monkeypatch.setenv("COORDINATOR_ADDRESS", f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("PROCESS_ID", "0")
    try:
        assert initialize_from_env("gloo") and initialize_from_env("gloo")  # idempotent
        dp = make_mesh(device="cpu")
        assert (dp.rank, dp.world, dp.main) == (0, 1, True) and dp.group is not None
    finally:
        torch.distributed.destroy_process_group()


def test_world_of_one_equals_the_trainer_without_dp(monkeypatch):
    """A one-rank gloo group (the all-reduces run) against no ``dp`` at all,
    on a split the batch divides: the same records and weights, bit for bit.
    Recorded, each step's two all-reduces (the loss's and the gradients')
    are ``allreduce`` spans inside its ``grad`` span."""
    x, y = _darcy_data(16 + 8 + 8, seed=4)
    split = (x[:16], y[:16], x[16:24], y[16:24], x[24:], y[24:])
    cfg = TrainConfig(**dict(DARCY_CFG, epochs=2))
    base = _port_model("uno9", DARCY_KW).state_dict()
    runs = []
    for ms in (False, True):
        model = _port_model("uno9", DARCY_KW, base)
        logger = _List()
        dp = None
        if ms:
            for k in ENV_KEYS:
                monkeypatch.delenv(k, raising=False)
            monkeypatch.setenv("WORLD_SIZE", "1")
            monkeypatch.setenv("RANK", "0")
            assert initialize_from_env("gloo")
            dp = make_mesh(device="cpu")
        if ms:
            start_recording()
        try:
            out = train_darcy(model, *split, cfg, logger=logger, dp=dp)
        finally:
            if ms:
                rec = stop_recording()
                torch.distributed.destroy_process_group()
        runs.append((logger.records, out, model.state_dict()))
    (r_a, o_a, s_a), (r_b, o_b, s_b) = runs
    grads = [i for i, s in enumerate(rec.spans) if s[0] == "grad"]
    assert len(grads) == 4 and all(s[0] != "allreduce" or s[3] in grads for s in rec.spans)
    for g in grads:
        assert sum(s[0] == "allreduce" and s[3] == g for s in rec.spans) == 2
    drop = {"t", "epoch_sec", "samples_per_sec", "step_ms"}
    assert [{k: v for k, v in r.items() if k not in drop} for r in r_a] == \
           [{k: v for k, v in r.items() if k not in drop} for r in r_b]
    assert o_a["test_rel_l2"] == o_b["test_rel_l2"] and o_a["step"] == o_b["step"] == 4
    assert all(torch.equal(s_a[k], s_b[k]) for k in s_a)


def test_cli_train_data_parallel_over_two_processes(tmp_path, capsys):
    """``cli train --data-parallel --device cpu`` as two ranks over gloo: rank
    0 alone prints and writes the log and the checkpoints; the val split of 1
    is below the batch of 2, so under data parallelism it evaluates nothing
    (0.0); the first epoch's train loss is the one-process run's."""
    from tests.test_torch_train import _split_cache
    from uno_tpu_torch import cli

    data, log, ck = (str(tmp_path / n) for n in ("d.npz", "run.jsonl", "ck"))
    _split_cache(data)
    argv = ["train", "--preset", "darcy_s85", "--data-cache", data, "--ntrain", "2", "--nval",
            "1", "--ntest", "1", "--epochs", "1", "--batch-size", "2", "--device", "cpu"]
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    env.update(PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(WORLD), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-m", "uno_tpu_torch.cli", *argv,
                               "--data-parallel", "--log", log, "--checkpoint-dir", ck],
                              env=dict(env, RANK=str(r)), cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    lines = [[json.loads(l) for l in o.splitlines() if l.startswith("{")] for o in outs]
    assert lines[1] == [] and len(lines[0]) == 2
    with open(log) as f:
        assert [json.loads(l) for l in f] == lines[0]
    epoch, test = lines[0]
    assert (epoch["step"], epoch["val_rel_l2"], test["test_rel_l2"]) == (1, 0.0, 0.0)
    assert all(os.path.exists(os.path.join(ck, n + ".pt")) for n in ("best_params", "train_state"))

    assert cli.main(argv) == 0
    single = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert epoch["train_rel_l2"] == pytest.approx(single[0]["train_rel_l2"], rel=1e-5)


def test_trainer_refuses_a_batch_the_ranks_do_not_divide():
    from uno_tpu_torch.parallel import DataParallel

    dp = DataParallel(None, 0, 3, torch.device("cpu"))
    x, y = _darcy_data(4, seed=5)
    with pytest.raises(ValueError, match="does not split"):
        train_darcy(_port_model("uno9", DARCY_KW), x, y, x, y, x, y,
                    TrainConfig(epochs=1, batch_size=4), logger=_List(), dp=dp)


if __name__ == "__main__":
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "2")))
    _rank_main(sys.argv[1])
    torch.distributed.destroy_process_group()
    print(json.dumps({"rank": os.environ["RANK"], "ok": True}))
