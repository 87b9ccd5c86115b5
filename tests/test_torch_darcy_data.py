"""The port's Darcy ``.mat`` loaders and ``cli train/predict/eval --data``
for the Darcy presets against uno_tpu's.

The tests write their own files on the reference's 421-point grid, a few
samples each: MATLAB v5 with scipy and, where h5py is present, v7.3
(HDF5).  ``load_darcy`` and ``load_darcy_multi`` must give arrays equal to
uno_tpu's, bit for bit (both are numpy over one ``MatReader``), and the
CLI must hand the trainer, the predictor and the evaluator the six splits
that ``uno_tpu/cli.py:_load_task_data`` makes of the same files: one file
split first-n / last-n, two or more pooled and permuted by the preset's
seed.
"""

import argparse
import dataclasses
import json

import numpy as np
import pytest
import scipy.io
import torch

from uno_tpu import cli as jcli
from uno_tpu.configs.presets import PRESETS as JPRESETS
from uno_tpu.data import loaders as jloaders
from uno_tpu_torch import cli
from uno_tpu_torch.configs.presets import PRESETS
from uno_tpu_torch.data import loaders as tloaders

GRID = 421


def _fields(n, seed):
    """Coefficients of 3 and 12 and smooth-ish solutions, f32, (n, 421, 421)."""
    rng = np.random.default_rng(seed)
    a = np.where(rng.standard_normal((n, GRID, GRID)) > 0, 12.0, 3.0).astype(np.float32)
    u = rng.standard_normal((n, GRID, GRID)).astype(np.float32).cumsum(axis=1) / GRID
    return a, u.astype(np.float32)


def _write_v5(path, n, seed):
    a, u = _fields(n, seed)
    scipy.io.savemat(path, {"coeff": a, "sol": u})
    return a, u


def _write_v73(path, n, seed):
    """HDF5 stores MATLAB's column-major order: the reader reverses the axes."""
    h5py = pytest.importorskip("h5py")
    a, u = _fields(n, seed)
    with h5py.File(path, "w") as f:
        f.create_dataset("coeff", data=np.transpose(a, (2, 1, 0)))
        f.create_dataset("sol", data=np.transpose(u, (2, 1, 0)))
    return a, u


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("darcy")
    one, two = str(d / "one.mat"), str(d / "two.mat")
    _write_v5(one, 6, 0)
    _write_v5(two, 4, 1)
    return one, two


@pytest.mark.parametrize("r", [1, 2, 5])
def test_load_darcy_matches_uno_tpu_v5(files, r):
    got = tloaders.load_darcy(r, 4, 2, files[0])
    want = jloaders.load_darcy(r, 4, 2, files[0])
    _equal(got, want)
    s = (GRID - 1) // r + 1
    assert got[0].shape == (4, s, s, 1) and got[3].shape == (2, s, s)
    a, _ = _fields(6, 0)  # ::r of the full grid, the last ntest samples
    assert np.array_equal(got[2][..., 0], a[-2:, ::r, ::r])


def test_load_darcy_matches_uno_tpu_v73(tmp_path):
    path = str(tmp_path / "v73.mat")
    a, u = _write_v73(path, 3, 2)
    got = tloaders.load_darcy(2, 2, 1, path)
    _equal(got, jloaders.load_darcy(2, 2, 1, path))
    assert np.array_equal(got[0][..., 0], a[:2, ::2, ::2])
    assert np.array_equal(got[3], u[-1:, ::2, ::2])


@pytest.mark.parametrize("sub,split", [(2, (5, 2, 3)), (5, (6, 0, 4)), (1, (3, 3, 2))])
def test_load_darcy_multi_matches_uno_tpu(files, sub, split):
    """The reference's 4:1 block per file (4 + 2 and 3 + 1 of 6 and 4
    samples), pooled and permuted by a seeded default_rng."""
    got = tloaders.load_darcy_multi(list(files), *split, sub=sub, seed=10001)
    _equal(got, jloaders.load_darcy_multi(list(files), *split, sub=sub, seed=10001))
    assert [len(x) for x in got] == [split[0]] * 2 + [split[1]] * 2 + [split[2]] * 2
    with pytest.raises(ValueError, match="exceeds pooled samples 10"):
        tloaders.load_darcy_multi(list(files), 8, 2, 1, sub=sub)


def _splits(name, paths, ntrain, nval, ntest):
    """(port, uno_tpu) six-array splits of one Darcy preset from --data."""
    over = dict(ntrain=ntrain, nval=nval, ntest=ntest)
    args = argparse.Namespace(data=list(paths), generate=False, data_cache=None,
                              gen_dt=None, gen_T=None)
    want = jcli._load_task_data(dataclasses.replace(JPRESETS[name], **over), args)
    got = cli._load_data(args, dataclasses.replace(PRESETS[name], **over),
                         torch.device("cpu"))
    return got, want


@pytest.mark.parametrize("name", ["darcy_s85", "darcy_s211", "darcy_s421"])
@pytest.mark.parametrize("n_files", [1, 2])
def test_cli_data_splits_match_uno_tpus(files, name, n_files):
    got, want = _splits(name, files[:n_files], 3, 2, 1)
    _equal(got, want)
    s = (GRID - 1) // PRESETS[name].sub + 1
    assert [x.shape[1] for x in got] == [s] * 6 and [len(x) for x in got] == [3, 3, 2, 2, 1, 1]


def test_cli_train_predict_eval_see_uno_tpus_splits(files, tmp_path, monkeypatch, capsys):
    """``cli train``, ``predict`` and ``eval`` of darcy_s85 on two files, on
    the CPU: each loads the splits uno_tpu's cli makes, train writes a
    checkpoint, predict writes the test split's input and target, eval
    reports val and test."""
    _, want = _splits("darcy_s85", files, 3, 1, 2)
    seen = []
    load = cli._load_data

    def spy(args, preset, device):
        seen.append((args.cmd, load(args, preset, device)))
        return seen[-1][1]

    monkeypatch.setattr(cli, "_load_data", spy)
    ck, out = str(tmp_path / "ck"), str(tmp_path / "p.npz")
    split = ["--preset", "darcy_s85", "--data", *files, "--ntrain", "3", "--nval", "1",
             "--ntest", "2", "--batch-size", "2", "--device", "cpu"]
    assert cli.main(["train", *split, "--epochs", "1", "--checkpoint-dir", ck]) == 0
    assert cli.main(["predict", *split, "--checkpoint-dir", ck, "--out", out]) == 0
    assert cli.main(["eval", *split, "--checkpoint-dir", ck]) == 0
    assert [cmd for cmd, _ in seen] == ["train", "predict", "eval"]
    for _, got in seen:
        _equal(got, want)
    z = np.load(out)
    assert np.array_equal(z["input"], want[4]) and np.array_equal(z["target"], want[5])
    assert z["pred"].shape == (2, 85, 85) and np.isfinite(z["pred"]).all()
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(report["val_rel_l2"]) and np.isfinite(report["test_rel_l2"])


def test_cli_generate_darcy_reports_its_solve(tmp_path, capsys):
    """``cli generate --task darcy`` prints one JSON line with its solve:
    the ms taken, the CG iterations and the final relative residual."""
    out = str(tmp_path / "d.mat")
    assert cli.main(["generate", "--task", "darcy", "--out", out, "--n", "2", "--size", "33",
                     "--seed", "2", "--device", "cpu"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    report = lines[-1]
    assert report["generate"] == "darcy" and (report["n"], report["size"]) == (2, 33)
    assert 0 < report["cg_iterations"] <= 2000 and report["residual"] < 1e-5
    assert report["ms"] > 0 and report["device"] == "cpu"
    assert scipy.io.loadmat(out)["coeff"].shape == (2, 33, 33)
