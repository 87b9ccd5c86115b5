"""Guards of the PyTorch port: it never imports JAX, and its framework-free
copies of uno_tpu code (spec dataclasses, 2-D and 3-D factories, the Darcy,
NS-2D and NS-3D presets and their TrainConfig, resample tables, partial-DFT tables,
the GRF's DCT matrix, ``MatReader`` and the NS loader) stay equal to the
originals."""

import dataclasses
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

from uno_tpu.configs import presets as jpresets
from uno_tpu.data import grf as jgrf
from uno_tpu.data import loaders as jloaders
from uno_tpu.data import mat as jmat
from uno_tpu.ops import dft as jdft
from uno_tpu.models import core as jcore
from uno_tpu.models import uno2d as juno2d
from uno_tpu.models import uno3d as juno3d
from uno_tpu.ops.resample import resize_matrix as j_resize_matrix
from uno_tpu.train import common as jcommon
from uno_tpu_torch.configs import presets as tpresets
from uno_tpu_torch.data import grf as tgrf
from uno_tpu_torch.data import loaders as tloaders
from uno_tpu_torch.data import mat as tmat
from uno_tpu_torch.ops import dft as tdft
from uno_tpu_torch.models import MODEL_REGISTRY
from uno_tpu_torch.models import core as tcore
from uno_tpu_torch.ops.resample import resize_matrix
from uno_tpu_torch.train import common as tcommon

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_and_chip_smoke_import_no_jax():
    code = (
        "import sys, pkgutil, importlib, uno_tpu_torch, uno_tpu_torch.cli, "
        "uno_tpu_torch.models, uno_tpu_torch.optim, uno_tpu_torch.losses, "
        "uno_tpu_torch.train.darcy, uno_tpu_torch.train.ns2d, uno_tpu_torch.train.ns3d, "
        "uno_tpu_torch.models.uno3d, uno_tpu_torch.data.batching, "
        "uno_tpu_torch.data.ns_solver, uno_tpu_torch.data.mat, uno_tpu_torch.data.loaders, "
        "chip_smoke, tools.torch_ns2d_profile\n"
        "for m in pkgutil.walk_packages(uno_tpu_torch.__path__, 'uno_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'uno_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_spec_dataclasses_equal_uno_tpus():
    assert _fields(tcore.BlockSpec) == _fields(jcore.BlockSpec)
    assert _fields(tcore.UNOSpec) == _fields(jcore.UNOSpec)
    assert tcore.LIFT == jcore.LIFT
    for d in (85, 211, 247, 421):
        for f in (jcore.Fraction(1, 2), jcore.Fraction(3, 4), jcore.Fraction(1, 32)):
            assert tcore._scale(d, f) == jcore._scale(d, f)


_3D = sorted(n for n in MODEL_REGISTRY if n.startswith("uno3d"))


@pytest.mark.parametrize("name", sorted(set(MODEL_REGISTRY) - set(_3D)))
@pytest.mark.parametrize("kwargs", [{}, dict(width=8, pad=1), dict(width=20, factor=0.5)])
def test_2d_factories_equal_uno_tpus(name, kwargs):
    if name == "uno_demo":
        kwargs = {k: v for k, v in kwargs.items() if k != "factor"}
    got = MODEL_REGISTRY[name](**kwargs)
    want = getattr(juno2d, name)(**kwargs)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [type(b).__name__ for b in got.blocks] == ["BlockSpec"] * len(want.blocks)


@pytest.mark.parametrize("name", _3D)
@pytest.mark.parametrize("kwargs", [{}, dict(width=4, pad=3), dict(width=20, factor=0.5,
                                                                   pad_both=True)])
def test_3d_factories_equal_uno_tpus(name, kwargs):
    got = MODEL_REGISTRY[name](**kwargs)
    want = getattr(juno3d, name)(**kwargs)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [type(b).__name__ for b in got.blocks] == ["BlockSpec"] * len(want.blocks)


def test_model_registry_equals_uno_tpus():
    from uno_tpu.models import MODEL_REGISTRY as J_REGISTRY

    assert set(MODEL_REGISTRY) == set(J_REGISTRY) and len(_3D) == 8


def test_train_config_equals_uno_tpus():
    assert _fields(tcommon.TrainConfig) == _fields(jcommon.TrainConfig)


def test_darcy_presets_equal_uno_tpus():
    """The Darcy, NS-2D and, since the NS-3D slice, NS-3D presets: all of
    uno_tpu's."""
    assert set(tpresets.PRESETS) == set(jpresets.PRESETS)
    assert {p.task for p in tpresets.PRESETS.values()} == {"darcy", "ns2d", "ns3d"}
    assert [f.name for f in dataclasses.fields(tpresets.Preset)] == [
        f.name for f in dataclasses.fields(jpresets.Preset)]
    for name, got in tpresets.PRESETS.items():
        want = jpresets.PRESETS[name]
        for f in dataclasses.fields(got):
            if f.name != "train":
                assert getattr(got, f.name) == getattr(want, f.name), (name, f.name)
        assert [f.name for f in dataclasses.fields(got.train)] == [
            f.name for f in dataclasses.fields(want.train)]
        for f in dataclasses.fields(got.train):
            assert getattr(got.train, f.name) == getattr(want.train, f.name), (name, f.name)


@pytest.mark.parametrize("name,overrides", [
    ("darcy_s85", {}),
    ("darcy_s211", dict(epochs=3, batch_size=8, learning_rate=5e-4)),
    ("ns2d_s256", dict(ntrain=8, nval=4, ntest=4, eval_every=1)),
    ("ns3d_t9", dict(t_f=4, size=32, seed=7, weight_decay=0.0, model_kwargs=dict(width=2))),
])
def test_get_preset_overrides_equal_uno_tpus(name, overrides):
    """``get_preset(name, **overrides)``: TrainConfig fields go to ``train``,
    the others to the preset, as in uno_tpu; the registered preset stays as
    it was."""
    got = tpresets.get_preset(name, **dict(overrides))
    want = jpresets.get_preset(name, **dict(overrides))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for k, v in overrides.items():
        assert getattr(got.train if k in tcommon.TrainConfig.__dataclass_fields__ else got,
                       k) == v, k
    if overrides:
        assert got is not tpresets.PRESETS[name]
        assert dataclasses.asdict(tpresets.PRESETS[name]) == dataclasses.asdict(
            jpresets.PRESETS[name])


@pytest.mark.parametrize("kernel", ["linear", "cubic", "nearest"])
@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("antialias", [True, False])
def test_resize_matrix_equals_uno_tpus(kernel, align_corners, antialias):
    for n_in, n_out in [(247, 123), (61, 123), (7, 7), (10, 1), (1, 5), (33, 64)]:
        got = resize_matrix(n_in, n_out, kernel, align_corners, antialias)
        want = j_resize_matrix(n_in, n_out, kernel, align_corners, antialias)
        assert got.dtype == want.dtype
        assert np.array_equal(got, want), (n_in, n_out)


@pytest.mark.parametrize("n", [15, 16, 211])
def test_dft_tables_equal_uno_tpus(n):
    for idx in ((0, 1, 2, n - 3, n - 2, n - 1), tuple(range(n // 2 + 1))):
        for scaled in (True, False):
            for name in ("_fwd_real_T", "_fwd_cplx_T", "_inv_cplx_T"):
                got = getattr(tdft, name)(n, idx, scaled)
                want = getattr(jdft, name)(n, idx, scaled)
                assert got.dtype == want.dtype and np.array_equal(got, want), (name, idx)
            for c, w in zip(tdft._cs(n, idx, 3.0), jdft._cs(n, idx, 3.0)):
                assert np.array_equal(c, w)
    for m in (1, 3, n // 2 + 1):
        for scaled in (True, False):
            got, want = tdft._inv_real_T(m, n, scaled), jdft._inv_real_T(m, n, scaled)
            assert got.dtype == want.dtype and np.array_equal(got, want), m
    for name in ("_fwd_real_T", "_fwd_cplx_T", "_inv_cplx_T", "_inv_real_T"):
        assert getattr(tdft, name).cache_info().maxsize == 256
    assert tdft.PLANE_AXIS == jdft.PLANE_AXIS


def test_idct2_matrix_equals_uno_tpus():
    for s in (1, 8, 33, 211):
        got, want = tgrf._idct2_matrix(s), jgrf._idct2_matrix(s)
        assert got.dtype == want.dtype and np.array_equal(got, want), s


@pytest.mark.parametrize("copy,original", [
    (tmat.MatReader, jmat.MatReader),
    (tloaders._bilinear_resize_hw, jloaders._bilinear_resize_hw),
    (tloaders.load_navier_stokes, jloaders.load_navier_stokes),
    (tloaders.load_darcy, jloaders.load_darcy),
    (tloaders.load_darcy_multi, jloaders.load_darcy_multi),
    (tgrf._wavenumbers, jgrf._wavenumbers),
])
def test_data_copies_equal_uno_tpus(copy, original):
    assert inspect.getsource(copy) == inspect.getsource(original)
