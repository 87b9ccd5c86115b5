"""The port's NS data path against uno_tpu's, on the CPU: the periodic GRF,
the Navier–Stokes solver, the ``.mat`` reader and loader, ``cli generate
--task ns``, ``cli train --data`` and the NS data cache.

* ``GaussianRF.sample_from_noise`` fed the noise that ``uno_tpu``'s
  ``sample(key, n)`` draws (``jax.random.normal`` of the two halves of
  ``split(key)``) equals that sample: rel-L2 <= 1e-5 (f32 FFTs of two
  libraries);
* ``navier_stokes_2d`` from the same ``w0`` for 150 steps of 1e-3: rel-L2
  <= 1e-5 per recorded frame (f32 rounding grows with the horizon: 2e-7 per
  100 steps at 64x64); ``sol_t`` and ``default_forcing`` equal;
* ``MatReader`` and ``load_navier_stokes`` (64 -> 32 resize) equal
  ``uno_tpu``'s on files the tests write;
* a cache written by either package's cli loads in the other's.
"""

import argparse
import dataclasses
import json

import jax
import numpy as np
import pytest
import scipy.io
import torch

from uno_tpu import cli as jcli
from uno_tpu.configs.presets import get_preset as j_get_preset
from uno_tpu.data import grf as jgrf
from uno_tpu.data import loaders as jloaders
from uno_tpu.data import mat as jmat
from uno_tpu.data import ns_solver as jns
from uno_tpu_torch import cli
from uno_tpu_torch.configs import presets
from uno_tpu_torch.data import grf, loaders, mat, ns_solver


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@pytest.mark.parametrize("dim,size", [(2, 32), (2, 64), (1, 64), (3, 8)])
def test_gaussian_rf_from_jax_noise_matches_uno_tpu(dim, size):
    key = jax.random.PRNGKey(5)
    jrf = jgrf.GaussianRF(dim, size, alpha=2.5, tau=7.0)
    want = np.asarray(jrf.sample(key, 3))
    kr, ki = jax.random.split(key)
    shape = (3,) + (size,) * dim
    re, im = (torch.from_numpy(np.array(jax.random.normal(k, shape))) for k in (kr, ki))
    rf = grf.GaussianRF(dim, size, alpha=2.5, tau=7.0)
    assert np.array_equal(rf.sqrt_eig, np.asarray(jrf.sqrt_eig))
    got = rf.sample_from_noise(re, im)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) <= 1e-5, _rel(got.numpy(), want)


def test_gaussian_rf_draws_from_the_generator():
    rf = grf.GaussianRF(2, 32, alpha=2.5, tau=7.0)
    a = rf.sample(torch.Generator().manual_seed(3), 4)
    b = rf.sample(torch.Generator().manual_seed(3), 4)
    c = rf.sample(torch.Generator().manual_seed(4), 4)
    assert a.shape == (4, 32, 32) and torch.equal(a, b) and not torch.equal(a, c)
    assert abs(float(a.mean())) < 1e-5  # the zero mode is dropped
    with pytest.raises(ValueError):
        grf.GaussianRF(4, 8)


@pytest.mark.parametrize("s", [32, 64])
def test_default_forcing_equals_uno_tpus(s):
    got = ns_solver.default_forcing(s)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(jns.default_forcing(s)))


@pytest.fixture(scope="module")
def w0():
    return np.array(jgrf.GaussianRF(2, 64, alpha=2.5, tau=7.0).sample(jax.random.PRNGKey(0), 2))


@pytest.mark.parametrize("T,dt,record", [(0.15, 1e-3, 5), (0.0105, 1e-3, 4)])
def test_navier_stokes_2d_matches_uno_tpu(w0, T, dt, record):
    """150 steps in 5 records; and 11 steps (ceil(10.5)) in 4 records of 2,
    where the last step is dropped as in uno_tpu."""
    f = ns_solver.default_forcing(64)
    want, want_t = jns.navier_stokes_2d(jax.numpy.asarray(w0), jns.default_forcing(64),
                                        visc=1e-3, T=T, delta_t=dt, record_steps=record)
    got, got_t = ns_solver.navier_stokes_2d(torch.from_numpy(w0), f, visc=1e-3, T=T,
                                            delta_t=dt, record_steps=record)
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, 64, 64, record)
    assert np.array_equal(got_t.numpy(), np.asarray(want_t))
    for r in range(record):
        err = _rel(got[..., r].numpy(), want[..., r])
        assert err <= 1e-5, (r, err)
    assert not np.allclose(got[..., 0].numpy(), w0)  # it moved


def test_mat_reader_matches_uno_tpus(tmp_path):
    v5 = str(tmp_path / "v5.mat")
    a = np.random.default_rng(0).standard_normal((3, 5, 7))
    scipy.io.savemat(v5, {"coeff": a})
    paths = [v5]
    try:
        import h5py
    except ImportError:  # the v7.3 path needs h5py
        h5py = None
    if h5py is not None:
        v73 = str(tmp_path / "v73.mat")
        with h5py.File(v73, "w") as f:
            f.create_dataset("coeff", data=a)
        paths.append(v73)
    for path in paths:
        for to_float in (True, False):
            got = mat.MatReader(path, to_float).read_field("coeff")
            want = jmat.MatReader(path, to_float).read_field("coeff")
            assert got.dtype == want.dtype and np.array_equal(got, want), (path, to_float)


def test_load_navier_stokes_matches_uno_tpus(tmp_path):
    path = str(tmp_path / "ns.mat")
    rng = np.random.default_rng(2)
    scipy.io.savemat(path, {f"u{i}": rng.standard_normal((4, 64, 64, 20)).astype(np.float32)
                            for i in range(3)})
    kw = dict(train=8, test=4, sample_num=12, batch=4, t_in=10, t_out=10, size=32)
    got = loaders.load_navier_stokes(path, **kw)
    want = jloaders.load_navier_stokes(path, **kw)
    assert [g.shape for g in got] == [(8, 32, 32, 10)] * 2 + [(4, 32, 32, 10)] * 2
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    x = rng.standard_normal((2, 33, 17, 3)).astype(np.float32)
    assert np.array_equal(loaders._bilinear_resize_hw(x, 24), jloaders._bilinear_resize_hw(x, 24))


def _tiny(monkeypatch, **over):
    """ns2d at width 8 and T_f = 3, registered for the CLI as ``ns2d_tiny``."""
    p = dataclasses.replace(presets.PRESETS["ns2d"], name="ns2d_tiny",
                            model_kwargs=dict(in_width=14, width=8, pad=0), t_f=3, **over)
    monkeypatch.setitem(presets.PRESETS, "ns2d_tiny", p)
    return p


def test_cli_generate_ns_then_train_on_the_mat(tmp_path, monkeypatch, capsys):
    """``generate --task ns`` writes two batches of 20 trajectories at 32x32;
    ``train --data`` reads them resized to the preset's 64x64 (16 train, 4
    val, 20 test) and trains an epoch; ``eval`` serves its checkpoint."""
    _tiny(monkeypatch)
    out = str(tmp_path / "ns.mat")
    assert cli.main(["generate", "--task", "ns", "--out", out, "--n", "40", "--size", "32",
                     "--T", "0.13", "--delta-t", "0.01", "--record-steps", "13",
                     "--seed", "3", "--device", "cpu"]) == 0
    m = scipy.io.loadmat(out)
    for i in range(2):
        assert m[f"a{i}"].shape == (20, 32, 32) and m[f"u{i}"].shape == (20, 32, 32, 13)
        np.testing.assert_allclose(m[f"t{i}"].ravel(), np.arange(1, 14) * 0.01, rtol=1e-6)
        assert np.isfinite(m[f"u{i}"]).all()
    # the same trajectories again from the seed; uno_tpu's loader reads the file
    again = str(tmp_path / "again.mat")
    cli.main(["generate", "--task", "ns", "--out", again, "--n", "20", "--size", "32",
              "--T", "0.13", "--delta-t", "0.01", "--record-steps", "13", "--seed", "3",
              "--device", "cpu"])
    assert np.array_equal(scipy.io.loadmat(again)["u0"], m["u0"])
    ta, tu, sa, su = jloaders.load_navier_stokes(out, train=20, test=20, sample_num=40,
                                                 t_in=10, t_out=3, size=64)
    assert ta.shape == sa.shape == (20, 64, 64, 10) and tu.shape == (20, 64, 64, 3)

    capsys.readouterr()
    split = ["--preset", "ns2d_tiny", "--data", out, "--ntrain", "16", "--nval", "4",
             "--ntest", "20", "--batch-size", "8", "--device", "cpu"]
    ck = str(tmp_path / "ck")
    assert cli.main(["train", *split, "--epochs", "1", "--checkpoint-dir", ck]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert lines[0]["epoch"] == 0 and lines[0]["step"] == 2 and len(lines[0]["step_ms"]) == 2
    assert {"val_step_rel_l2", "val_traj_rel_l2", "saved"} <= set(lines[0])
    test = lines[-1]
    assert np.isfinite([test["test_step_rel_l2"], test["test_traj_rel_l2"]]).all()
    # eval of the saved best params gives the trainer's val and test numbers
    assert cli.main(["eval", *split, "--checkpoint-dir", ck]) == 0
    ev = json.loads(capsys.readouterr().out.splitlines()[-1])
    for k in ("val_step_rel_l2", "val_traj_rel_l2"):
        assert ev[k] == pytest.approx(lines[0][k], rel=1e-6)
    for k in ("test_step_rel_l2", "test_traj_rel_l2"):
        assert ev[k] == pytest.approx(test[k], rel=1e-6)


def _ns_args(gen_dt=None, gen_T=None):
    return argparse.Namespace(generate=True, data=None, data_cache=None, gen_dt=gen_dt,
                              gen_T=gen_T)


def test_ns_cache_loads_in_uno_tpu_and_back(tmp_path, monkeypatch):
    # the default signature of the preset, and one with the generator's flags
    for p in ("ns2d", "ns2d_s256"):
        assert cli._gen_sig(presets.PRESETS[p]) == jcli._gen_sig(j_get_preset(p), _ns_args())
    tiny = dataclasses.replace(_tiny(monkeypatch, size=16), ntrain=1, nval=1, ntest=1)
    jtiny = dataclasses.replace(j_get_preset("ns2d"), t_f=3, size=16, ntrain=1, nval=1, ntest=1)
    args = _ns_args(gen_dt=0.005, gen_T=0.065)  # 13 steps, one per recorded frame
    assert cli._gen_sig(tiny, 0.005, 0.065) == jcli._gen_sig(jtiny, args)

    path = str(tmp_path / "gen.npz")
    data = cli._load_data(argparse.Namespace(**{**vars(args), "data_cache": path}), tiny,
                          torch.device("cpu"))
    assert [d.shape for d in data] == [(1, 16, 16, 10), (1, 16, 16, 3)] * 3
    assert np.isfinite(np.concatenate([d.ravel() for d in data])).all()
    jdata = jcli._cached(path, lambda: pytest.fail("regenerated"), sig=jcli._gen_sig(jtiny, args))
    for a, b in zip(data, jdata):
        assert np.array_equal(a, b)
    # the reverse: a cache uno_tpu writes, read by the port's cli
    path2 = str(tmp_path / "jax.npz")
    fake = [np.full((1, 16, 16, 10 if i % 2 == 0 else 3), i, np.float32) for i in range(6)]
    jcli._cached(path2, lambda: fake, sig=jcli._gen_sig(jtiny, args))
    got = cli._cached(path2, None, cli._gen_sig(tiny, 0.005, 0.065))
    for a, b in zip(got, fake):
        assert np.array_equal(a, b)
    # another horizon is another signature
    with pytest.raises(SystemExit, match="different config"):
        cli._cached(path2, None, cli._gen_sig(tiny, 0.005, 0.07))


def test_cli_generate_ns_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = str(tmp_path / "ns.mat")
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["generate", "--task", "ns", "--out", out, "--n", "2"])
    # Darcy --data reads the file (the generator wrote none)
    with pytest.raises(OSError):
        cli.main(["train", "--preset", "darcy_s85", "--data", out, "--device", "cpu"])
