"""Spatial domain decomposition in the port (``parallel/spatial.py``, the
split forms of the ops, ``UNOModel(split=)``, the trainers on a mesh with a
``spatial`` axis) against the unsplit port and ``uno_tpu``, on the CPU.

Two ranks run as two processes joined over gloo, and a 2 x 2 (data x
spatial) mesh as four; this file is their script (``_rank_main``).  They
run every case once and save what they saw, while this process runs
``uno_tpu``'s trainers under ``make_mesh(n_data=1, n_spatial=2)`` and
``make_mesh(n_data=2, n_spatial=2)`` on the conftest's virtual CPU devices.

Bounds:
* each split op against its unsplit self in float64, forward, input
  gradient and weight gradient (summed over the ranks): 1e-10; a complex128
  ``gradcheck`` of the spectral weights through the split convs;
* uno9's split forward against ``uno_tpu``'s unsharded forward: atol 2e-5
  (``tests/test_distributed.py:102-121``);
* one Darcy step on a grid the ranks do not divide (87 + 2 pad = 89 rows:
  44 + 45) against one process: rtol 1e-5 / atol 1e-5 (``:124-172``);
* the trainers against ``uno_tpu``'s under a spatial mesh:
  ``tests/test_torch_parallel.py``'s bounds (each epoch's losses rel 1e-3,
  the weights rel-L2 1e-3, the ranks' weights bit for bit).
"""

import json
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import (
    DARCY_CFG,
    DARCY_KW,
    ENV_KEYS,
    LOSS_KEYS,
    MODELS,
    NS2D_T_F,
    NS3D_T_F,
    NS_CFG,
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
from uno_tpu_torch.ops import spectral
from uno_tpu_torch.ops.norm import instance_norm
from uno_tpu_torch.ops.resample import resize
from uno_tpu_torch.optim import ComplexAdam
from uno_tpu_torch.parallel import Split, dp_value_and_grad, make_mesh, psum
from uno_tpu_torch.train.common import TrainConfig
from uno_tpu_torch.train.darcy import train_darcy
from uno_tpu_torch.train.ns2d import train_ns2d
from uno_tpu_torch.train.ns3d import train_ns3d

OP_TOL = 1e-10
STEP_S, STEP_KW = 87, dict(in_width=3, width=8, pad=1)  # 89 padded rows: 44 + 45
STEP_LR, STEP_WD = 1e-3, 1e-3


# ------------------------------------------------------------- the op cases

def _cplx(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))


def _with_dft(fn, on):
    def run(*args):
        spectral.set_dft_mode(on)
        try:
            return fn(*args)
        finally:
            spectral.set_dft_mode(None)
    return run


def _op_cases():
    """name -> (x, weights, out rows, fn(x, weights, split)), float64: x
    (B, C, n, ...) with its first grid axis (axis 2) split."""
    rng = np.random.default_rng(7)
    x2 = torch.from_numpy(rng.standard_normal((2, 3, 29, 20)))
    x3 = torch.from_numpy(rng.standard_normal((2, 3, 13, 12, 10)))
    w2 = _cplx(rng, (2, 3, 4, 5, 6))
    w3 = _cplx(rng, (4, 3, 2, 3, 4, 4))
    scale = torch.from_numpy(rng.standard_normal(3))
    bias = torch.from_numpy(rng.standard_normal(3))
    y = torch.from_numpy(rng.standard_normal((2, 29, 20)))
    cases = {}
    for path, dft in (("fft", False), ("dft", True)):
        for out in ((15, 10), (8, 12), (40, 24)):  # (8, 12): 2*m1 > d1, the overlap
            cases[f"conv2d_{path}_{out[0]}"] = (x2, [w2], out[0], _with_dft(
                lambda x, w, sp, out=out: spectral.spectral_conv_2d(x, w[0], out, (5, 6), sp),
                dft))
        for out in ((9, 10, 14), (5, 7, 8)):
            cases[f"conv3d_{path}_{out[0]}"] = (x3, [w3], out[0], _with_dft(
                lambda x, w, sp, out=out: spectral.spectral_conv_3d(x, w[0], out, (3, 4, 4),
                                                                    sp), dft))
            cases[f"truncate3d_{path}_{out[0]}"] = (x3, [], out[0], _with_dft(
                lambda x, w, sp, out=out: spectral.fourier_truncate_3d(x, out, sp), dft))
    cases["resize_cubic_down"] = (x2, [], 12, lambda x, w, sp: resize(
        x, (12, 9), (2, 3), "cubic", True, True, sp))
    cases["resize_cubic_up"] = (x2, [], 61, lambda x, w, sp: resize(
        x, (61, 20), (2, 3), "cubic", True, True, sp))
    cases["resize_trilinear"] = (x3, [], 9, lambda x, w, sp: resize(
        x, (9, 12, 14), (2, 3, 4), "linear", True, False, sp))
    cases["instance_norm"] = (x2, [scale, bias], 29, lambda x, w, sp: instance_norm(
        x, w[0], w[1], split=sp))
    cases["loss"] = (x2[:, 0], [y], None, lambda x, w, sp: relative_lp_loss(
        x, w[0] if sp is None else w[0][:, slice(*sp.rows())], reduction="none",
        group=None if sp is None else sp.group))
    return cases


def _cotangent(name, shape):
    return torch.from_numpy(np.random.default_rng(zlib.crc32(name.encode())).standard_normal(shape))


def _run_op(fn, x, ws, split, g):
    """Forward, then the backward of <y, g>: (y, dx, [dw])."""
    x = x.clone().requires_grad_()
    ws = [w.clone().requires_grad_() for w in ws]
    y = fn(x, ws, split)
    (y * g).sum().backward()
    return y.detach(), x.grad, [w.grad for w in ws]


def _split_op(name, case, axis):
    """A case on this rank's rows: (output rows, y, dx, dws).  The loss
    splits axis 1 of its (B, n, S) inputs and is whole on every rank."""
    x, ws, n_out, fn = case
    if n_out is None:  # whole on every rank: seeded once (rule 2)
        split = axis.split(x.shape[1])
        lo, hi = split.rows()
        once = lambda x, w, sp: _Once.apply(fn(x, w, sp), sp.rank)  # noqa: E731
        return (0, x.shape[0]), *_run_op(once, x[:, lo:hi], ws, split, _cotangent(name, (2,)))
    split = axis.split(x.shape[2])
    lo, hi = split.rows()
    out_rows = split.at(n_out).rows()
    g = _cotangent(name, list(fn(x, ws, None).shape))
    return out_rows, *_run_op(fn, x[:, :, lo:hi], ws, split,
                              g[:, :, out_rows[0]:out_rows[1]])


class _Whole(torch.autograd.Function):
    """A weight every rank holds whole: identity forward, and the rule-3
    sum of the ranks' gradients (``parallel/spatial.py``) as the backward."""

    @staticmethod
    def forward(ctx, w, group):
        ctx.group = group
        return w.clone()

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        torch.distributed.all_reduce(torch.view_as_real(g), group=ctx.group)
        return g, None


class _Once(torch.autograd.Function):
    """A value every rank holds whole, seeded on rank 0 only (rule 2), but
    the same value on every rank (``count_once`` scales it by zero)."""

    @staticmethod
    def forward(ctx, y, rank):
        ctx.rank = rank
        return y.clone()

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.rank == 0 else torch.zeros_like(g)), None


def _gradcheck_cases(axis):
    """complex128 gradcheck of the spectral weights through the split 2-D
    (both paths) and 3-D convs, at small shapes: a real function of the
    weights, whole on every rank."""
    rng = np.random.default_rng(3)
    cases = {
        "conv2d_fft": (torch.from_numpy(rng.standard_normal((1, 2, 9, 8))),
                       _cplx(rng, (2, 2, 1, 3, 3)), False,
                       lambda x, w, sp: spectral.spectral_conv_2d(x, w, (5, 8), (3, 3), sp)),
        "conv2d_dft": (torch.from_numpy(rng.standard_normal((1, 2, 9, 8))),
                       _cplx(rng, (2, 2, 1, 3, 3)), True,
                       lambda x, w, sp: spectral.spectral_conv_2d(x, w, (5, 8), (3, 3), sp)),
        "conv3d_fft": (torch.from_numpy(rng.standard_normal((1, 2, 7, 6, 6))),
                       _cplx(rng, (4, 2, 1, 2, 2, 2)), False,
                       lambda x, w, sp: spectral.spectral_conv_3d(x, w, (5, 6, 6), (2, 2, 2),
                                                                  sp)),
    }
    out = {}
    for name, (x, w, dft, fn) in cases.items():
        split = axis.split(x.shape[2])
        lo, hi = split.rows()
        r = _cotangent(name, list(fn(x, w, None).shape))
        olo, ohi = split.at(r.shape[2]).rows()
        xs, r = x[:, :, lo:hi], r[:, :, olo:ohi]

        def f(w, fn=fn, xs=xs, r=r, split=split):
            y = fn(xs, _Whole.apply(w, split.group), split)
            return _Once.apply(psum((y * r).flatten(1).sum(-1), split.group), split.rank)

        spectral.set_dft_mode(dft)
        try:
            out[name] = torch.autograd.gradcheck(f, (w.clone().requires_grad_(),), eps=1e-6,
                                                 atol=1e-7, rtol=1e-5)
        finally:
            spectral.set_dft_mode(None)
    return out


# ---------------------------------------------------------------- the ranks

def _step(model, dp, x, y, split):
    """One Darcy step (sum loss, ComplexAdam): the loss and the weights."""
    opt = ComplexAdam(model.parameters(), lr=STEP_LR, weight_decay=STEP_WD)

    def loss_fn(x, y):
        out = model(x, split=split).reshape(y.shape)
        return relative_lp_loss(out, y, group=None if split is None else split.group)

    loss, _ = dp_value_and_grad(loss_fn, dp, model.parameters())(x, y)
    opt.step()
    return float(loss), {k: v.clone() for k, v in model.state_dict().items()}


def _rank_main(out_dir: str, kind: str) -> None:
    from uno_tpu_torch.parallel import initialize_from_env

    assert initialize_from_env("gloo")
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    res = {}
    if kind == "mesh22":  # Darcy on a 2 x 2 (data x spatial) mesh
        dp = make_mesh(n_data=2, n_spatial=2, device="cpu")
        model = _port_model("uno9", DARCY_KW, inputs["init"]["darcy"])
        logger = _List()
        train_darcy(model, *inputs["splits"]["darcy"], TrainConfig(**DARCY_CFG),
                    logger=logger, dp=dp)
        res["darcy"] = dict(records=logger.records, state=model.state_dict())
        torch.save(res, os.path.join(out_dir, f"mesh22_rank{torch.distributed.get_rank()}.pt"))
        return
    dp = make_mesh(n_data=1, n_spatial=2, device="cpu")
    axis = dp.spatial
    cases = _op_cases()
    res["ops"] = {name: _split_op(name, case, axis) for name, case in cases.items()}
    res["gradcheck"] = _gradcheck_cases(axis)

    # uno9's forward and one Darcy step, split
    x, y = (torch.from_numpy(a) for a in inputs["step"])
    model = _port_model("uno9", STEP_KW, inputs["init"]["step"])
    rows = model.input_rows((STEP_S, STEP_S), axis)
    split = axis.split(STEP_S)
    with torch.no_grad():
        res["forward"] = dict(rows=rows, out=model(x[:, rows[0]:rows[1]], split=split))
    res["step"] = _step(model, dp, x[:, rows[0]:rows[1]], y[:, rows[0]:rows[1]], split)

    for task, trainer, name, kw, extra in (
            ("darcy", train_darcy, "uno9", DARCY_KW, dict(cfg=DARCY_CFG)),
            ("ns2d", train_ns2d, "uno", MODELS["ns2d"][1], dict(cfg=NS_CFG, t_f=NS2D_T_F)),
            ("ns3d", train_ns3d, "uno3d_t10", MODELS["ns3d"][1],
             dict(cfg=NS_CFG, t_f=NS3D_T_F))):
        model = _port_model(name, kw, inputs["init"][task])
        logger = _List()
        kwargs = {"t_f": extra["t_f"]} if "t_f" in extra else {}
        trainer(model, *inputs["splits"][task], TrainConfig(**extra["cfg"]), logger=logger,
                dp=dp, **kwargs)
        res[task] = dict(records=logger.records, state=model.state_dict())
    torch.save(res, os.path.join(out_dir, f"rank{axis.rank}.pt"))


# ------------------------------------------------------------ uno_tpu's side

def _jax_trainers(splits, trees, tasks, n_data):
    import jax

    from tests.test_torch_ns3d import _FixedInit
    from tests.test_torch_train import _JRecords
    from uno_tpu.models import build_model as jax_build_model
    from uno_tpu.parallel import make_mesh as jax_make_mesh
    from uno_tpu.train import TrainConfig as JTrainConfig
    from uno_tpu.train import train_darcy as j_train_darcy
    from uno_tpu.train import train_ns2d as j_train_ns2d
    from uno_tpu.train import train_ns3d as j_train_ns3d

    from uno_tpu.ops import spectral as jspectral

    mesh = jax_make_mesh(n_data=n_data, n_spatial=2)
    out = {}
    # XLA CPU's FFT thunk rejects the layouts a grid-sharded FFT gets
    # (tests/test_tensor_parallel.py:80-88): uno_tpu runs its partial-DFT
    # path here, the port its default FFT path
    jspectral.set_dft_mode(True)
    jax.clear_caches()
    try:
        for task, trainer, cfg, kw in (("darcy", j_train_darcy, DARCY_CFG, {}),
                                       ("ns2d", j_train_ns2d, NS_CFG, dict(t_f=NS2D_T_F)),
                                       ("ns3d", j_train_ns3d, NS_CFG, dict(t_f=NS3D_T_F))):
            if task not in tasks:
                continue
            name, mkw = MODELS[task]
            jm = _FixedInit(jax_build_model(name, **mkw), jax.tree.map(jax.numpy.asarray,
                                                                        trees[task]))
            rec = _JRecords()
            res = trainer(jm, *splits[task], JTrainConfig(**cfg), mesh=mesh, logger=rec, **kw)
            out[task] = (rec.records, res)
    finally:
        jspectral.set_dft_mode(None)
        jax.clear_caches()
    return out


def _start(out_dir, kind, world, threads):
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    env.update(PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(world), OMP_NUM_THREADS=str(threads))
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), out_dir, kind],
                             env=dict(env, RANK=str(r)), cwd=REPO, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _wait(procs):
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results (two ranks, then a 2 x 2 mesh) and uno_tpu's."""
    out_dir = str(tmp_path_factory.mktemp("spatial"))
    splits = _splits()
    init = {task: _port_model(name, kw).state_dict() for task, (name, kw) in MODELS.items()}
    trees = {task: bridge.params_to_flax(_port_model(*MODELS[task], init[task]))
             for task in MODELS}
    rng = np.random.default_rng(5)
    step = (rng.standard_normal((4, STEP_S, STEP_S, 1)).astype(np.float32),
            rng.standard_normal((4, STEP_S, STEP_S)).astype(np.float32))
    import jax
    import jax.numpy as jnp

    from uno_tpu.models import build_model as jax_build_model

    jm = jax_build_model("uno9", **STEP_KW)
    step_tree = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0),
                                                         jnp.asarray(step[0][:1])))
    init["step"] = bridge.params_from_flax(_port_model("uno9", STEP_KW), step_tree).state_dict()
    torch.save({"splits": splits, "init": init, "step": step},
               os.path.join(out_dir, "inputs.pt"))

    procs = _start(out_dir, "spatial2", 2, 2)
    try:
        jax_fwd = np.asarray(jax.jit(jm.apply)(step_tree, jnp.asarray(step[0])))
        jax_out = _jax_trainers(splits, trees, ("darcy", "ns2d", "ns3d"), n_data=1)
    finally:
        _wait(procs)
    procs = _start(out_dir, "mesh22", 4, 1)
    try:
        jax_mesh22 = _jax_trainers(splits, trees, ("darcy",), n_data=2)
    finally:
        _wait(procs)
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    mesh22 = [torch.load(os.path.join(out_dir, f"mesh22_rank{r}.pt"), weights_only=False)
              for r in range(4)]
    return dict(ranks=ranks, jax=jax_out, mesh22=mesh22, jax_mesh22=jax_mesh22,
                jax_fwd=jax_fwd, init=init, step=step)


@pytest.mark.parametrize("name", sorted(_op_cases()))
def test_split_op_equals_the_unsplit_op(runs, name):
    x, ws, n_out, fn = _op_cases()[name]
    y = fn(x, ws, None)
    want_y, want_dx, want_dw = _run_op(fn, x, ws, None, _cotangent(name, list(y.shape)))
    got = [r["ops"][name] for r in runs["ranks"]]
    for rows, y_r, dx_r, _ in got:
        part = want_y if n_out is None else want_y.narrow(2, rows[0], rows[1] - rows[0])
        assert (y_r - part).abs().max() <= OP_TOL
    dx = torch.cat([g[2] for g in got], dim=1 if n_out is None else 2)
    assert dx.shape == want_dx.shape and (dx - want_dx).abs().max() <= OP_TOL
    for i, w in enumerate(want_dw):  # each rank's part of a weight's gradient
        total = sum(g[3][i] for g in got)
        assert (total - w).abs().max() <= OP_TOL * max(1.0, float(w.abs().max()))


def test_gradcheck_of_the_spectral_weights_through_split_convs(runs):
    for r in runs["ranks"]:
        assert r["gradcheck"] == {"conv2d_fft": True, "conv2d_dft": True,
                                  "conv3d_fft": True}


def test_split_uno9_forward_matches_uno_tpu(runs):
    """The rows of the padded grid: 89 over 2 ranks are 44 + 45, so rank 0
    holds input rows 0-43 and rank 1 rows 44-86 and the two pad rows."""
    rows = [r["forward"]["rows"] for r in runs["ranks"]]
    assert rows == [(0, 44), (44, 87)]
    got = torch.cat([r["forward"]["out"] for r in runs["ranks"]], dim=1).numpy()
    np.testing.assert_allclose(got, runs["jax_fwd"], atol=2e-5)


def test_split_darcy_step_matches_one_process(runs):
    model = _port_model("uno9", STEP_KW, runs["init"]["step"])
    x, y = (torch.from_numpy(a) for a in runs["step"])
    loss, state = _step(model, None, x, y, None)
    for r in runs["ranks"]:
        got_loss, got_state = r["step"]
        assert got_loss == pytest.approx(loss, rel=1e-5)
        for k, v in state.items():
            a, b = (torch.view_as_real(t) if t.is_complex() else t for t in (got_state[k], v))
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5, err_msg=k)
    s0, s1 = (r["step"][1] for r in runs["ranks"])
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


def _check_training(records, state, jrecords, jout, task, other_states=()):
    tr = [r for r in records if "epoch" in r]
    jr = [r for r in jrecords if "epoch" in r]
    assert len(tr) == len(jr) > 0
    for a, b in zip(tr, jr):
        assert (a["epoch"], a["step"], a.get("saved")) == (b["epoch"], b["step"], b.get("saved"))
        for k in LOSS_KEYS[task]:
            assert a[k] == pytest.approx(b[k], rel=1e-3), (k, a[k], b[k])
    tests = [(k, v) for k, v in records[-1].items() if k.startswith("test_")]
    assert tests and all(v == pytest.approx(jout[k], rel=1e-3, abs=1e-12) for k, v in tests)
    for other in other_states:  # the ranks hold the same weights, bit for bit
        assert all(torch.equal(state[k], other[k]) for k in state)
    got = _flat_tree(bridge.params_to_flax(_port_model(*MODELS[task], state)))
    for path, w in _flat_tree(jout["params"]).items():
        assert _rel(got[path], w) <= 1e-3, (path, _rel(got[path], w))


@pytest.mark.parametrize("task", ["darcy", "ns2d", "ns3d"])
def test_split_training_matches_uno_tpus_spatial_mesh(runs, task):
    r0, r1 = (r[task] for r in runs["ranks"])
    assert r1["records"] == []  # only the mesh's rank 0 logs
    _check_training(r0["records"], r0["state"], *runs["jax"][task], task, [r1["state"]])


def test_data_by_spatial_mesh_matches_uno_tpus(runs):
    r = [m["darcy"] for m in runs["mesh22"]]
    assert all(x["records"] == [] for x in r[1:])
    _check_training(r[0]["records"], r[0]["state"], *runs["jax_mesh22"]["darcy"], "darcy",
                    [x["state"] for x in r[1:]])


def test_cli_train_spatial_over_two_processes(tmp_path, capsys):
    """``cli train --spatial 2 --device cpu`` as two ranks over gloo: rank 0
    alone prints; the losses are the one-process run's.  ``--spatial`` and
    ``--tensor-parallel`` together are refused."""
    from tests.test_torch_train import _split_cache
    from uno_tpu_torch import cli

    data = str(tmp_path / "d.npz")
    _split_cache(data, ntrain=2, nval=2, ntest=2)
    argv = ["train", "--preset", "darcy_s85", "--data-cache", data, "--ntrain", "2", "--nval",
            "2", "--ntest", "2", "--epochs", "1", "--batch-size", "2", "--device", "cpu"]
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    env.update(PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2", OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-m", "uno_tpu_torch.cli", *argv, "--spatial",
                               "2"], env=dict(env, RANK=str(r)), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    lines = [[json.loads(l) for l in o.splitlines() if l.startswith("{")] for o in outs]
    assert lines[1] == [] and len(lines[0]) == 2
    assert '"fused_head": false' in outs[0]

    assert cli.main(argv) == 0
    single = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    for k in ("train_rel_l2", "val_rel_l2"):
        assert lines[0][0][k] == pytest.approx(single[0][k], rel=1e-5)
    assert lines[0][1]["test_rel_l2"] == pytest.approx(single[1]["test_rel_l2"], rel=1e-5)
    with pytest.raises(SystemExit, match="mutually exclusive"):
        cli.main(argv + ["--spatial", "2", "--tensor-parallel", "2"])


def test_split_needs_the_last_block_at_the_padded_grid():
    """A 1-D split is refused (uno_tpu has no 1-D model or trainer), and so
    is a split of an axis shorter than the ranks."""
    from uno_tpu_torch.nn.layers import SpectralConv
    from uno_tpu_torch.parallel import partition

    conv = SpectralConv(2, 2, (3,))
    with pytest.raises(NotImplementedError, match="1-D"):
        conv(torch.zeros(1, 2, 8), (8,), Split(None, 0, 2, 8))
    with pytest.raises(ValueError, match="does not split"):
        partition(3, 4, 0)
    assert [partition(247, 4, r) for r in range(4)] == [(0, 61), (61, 123), (123, 185),
                                                        (185, 247)]


def test_batch_spatial_sharding_takes_the_ranks_rows():
    """``batch_spatial_sharding``: rank 1 of 2 keeps rows 123-246 of a
    247-row axis 1 by default, the rows it is given otherwise, and every
    row without a spatial axis."""
    from uno_tpu_torch.parallel import Axis, DataParallel, batch_spatial_sharding

    x = torch.arange(2 * 247).reshape(2, 247)
    dp = DataParallel(None, 0, 1, torch.device("cpu"), Axis(None, 1, 2))
    assert torch.equal(batch_spatial_sharding(dp, x), x[:, 123:])
    assert torch.equal(batch_spatial_sharding(dp, x, (100, 105)), x[:, 100:105])
    assert batch_spatial_sharding(DataParallel(None, 0, 1, torch.device("cpu")), x) is x
    assert not dp.main and dp.spatial_rank == 1


if __name__ == "__main__":
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "2")))
    _rank_main(sys.argv[1], sys.argv[2])
    torch.distributed.destroy_process_group()
