"""The port's serving artifact (``uno_tpu_torch/export.py``) against the eager
port and against ``uno_tpu``'s ``export_forward``/``load_forward``
(tests/test_export.py), on the CPU.

The 2-D models start from one ``uno_tpu`` init carried into the port by the
bridge; uno3d_t40 from the port's init carried into flax (a flax init of a
3-D model compiles for ~15 s).  Bounds: the loaded artifact against the
eager port rel-L2 <= 1e-5 (the same ops run: in fact equal); against
``uno_tpu``'s artifact rel-L2 <= 1e-5 in f32 (tests/test_export.py's
bound), and for uno9 under bf16 the model's bf16 bound, 2e-2 at seed 1
(tests/test_torch_model.py: the two packages round bf16 at other places).
"""

import os
import subprocess
import sys
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uno_tpu.export import export_forward as j_export_forward
from uno_tpu.export import load_forward as j_load_forward
from uno_tpu.models import build_model as jax_build_model
from uno_tpu_torch import bridge, cli
from uno_tpu_torch.export import export_forward, load_forward
from uno_tpu_torch.models import build_model
from uno_tpu_torch.nn.layers import OperatorBlock
from uno_tpu_torch.ops.kernels import cmul as C
from uno_tpu_torch.ops.kernels import mlp_head as H
from uno_tpu_torch.train.ns2d import make_rollout
from uno_tpu_torch.train.ns3d import forecast

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNO9 = dict(in_width=3, width=8, pad=1)
UNO = dict(in_width=14, width=8, pad=0)
UNO3D = dict(in_width=6, width=4, pad=3)
CONTRACT = "uno_tpu_torch.contract.default"
HEAD = "uno_tpu_torch.mlp_head_fwd.default"
REMAP = "uno_tpu_torch.remap.default"


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _custom_nodes(module) -> Counter:
    return Counter(str(n.target) for n in module.graph.nodes
                   if str(n.target).startswith("uno_tpu_torch."))


@pytest.fixture(scope="module")
def uno9_tree():
    """uno_tpu's uno9 init at seed 1 (the seed of the bf16 model bound)."""
    x = np.zeros((1, 85, 85, 1), np.float32)
    jm = jax_build_model("uno9", **UNO9)
    return jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x)))


def _port(name, kw, dtype, tree=None):
    model = build_model(name, dtype=dtype, generator=torch.Generator().manual_seed(0), **kw)
    return model if tree is None else bridge.params_from_flax(model, tree)


def _round_trip(model, jm, tree, x, jax_bound, tmp_path):
    """The port's artifact through a file against the eager port and against
    uno_tpu's artifact on the same weights; returns the loaded module."""
    path = str(tmp_path / "m.pt2")
    data = export_forward(model, torch.from_numpy(x), path=path)
    with open(path, "rb") as f:
        assert f.read() == data
    served = load_forward(path)
    got = served(torch.from_numpy(x)).detach()
    with torch.no_grad():
        eager = model(torch.from_numpy(x))
    assert got.dtype == eager.dtype and got.shape == eager.shape
    assert _rel(got, eager) <= 1e-5
    jfn = j_load_forward(j_export_forward(jm, jax.tree.map(jnp.asarray, tree), jnp.asarray(x)))
    want = np.asarray(jfn(jnp.asarray(x)), np.float32)
    assert got.shape == want.shape
    assert _rel(got.float().numpy(), want) <= jax_bound, _rel(got.float().numpy(), want)
    return served


@pytest.mark.parametrize("dtype,bound,n_head", [("float32", 1e-5, 0), ("bfloat16", 2e-2, 1)])
def test_uno9_round_trip_matches_eager_and_uno_tpus_artifact(uno9_tree, tmp_path, dtype, bound,
                                                           n_head):
    x = np.random.default_rng(0).standard_normal((2, 85, 85, 1)).astype(np.float32)
    model = _port("uno9", UNO9, dtype, uno9_tree)
    served = _round_trip(model, jax_build_model("uno9", dtype=dtype, **UNO9), uno9_tree, x,
                         bound, tmp_path)
    # one contraction node per 2-D spectral conv, and a remap per channel piece into it
    # and one out of it (f32 carries block 3's skip concat as two pieces); the fused
    # head under bf16
    assert _custom_nodes(served) == Counter({CONTRACT: 5, REMAP: 10 if n_head else 11,
                                             **({HEAD: 1} if n_head else {})})


def test_ns2d_step_round_trip(tmp_path):
    """One step of the NS-2D rollout: uno on a (B, 64, 64, T_in) window."""
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 10)).astype(np.float32)
    jm = jax_build_model("uno", **UNO)
    tree = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    model = _port("uno", UNO, "float32", tree)
    served = _round_trip(model, jm, tree, x, 1e-5, tmp_path)
    assert _custom_nodes(served) == Counter({CONTRACT: 7, REMAP: 16})  # two skips as pieces
    # the artifact of one step drives the rollout as the eager model does
    xx, yy = torch.from_numpy(x), torch.zeros(2, 64, 64, 2)
    with torch.no_grad():
        got, want = make_rollout(served, 2)(xx, yy)[1], make_rollout(model, 2)(xx, yy)[1]
    assert _rel(got, want) <= 1e-5


def test_uno3d_t40_round_trip(tmp_path):
    x = np.random.default_rng(2).standard_normal((1, 64, 64, 10, 1)).astype(np.float32)
    model = _port("uno3d_t40", UNO3D, "float32")
    served = _round_trip(model, jax_build_model("uno3d_t40", **UNO3D),
                         bridge.params_to_flax(model), x, 1e-5, tmp_path)
    # a 3-D model has no fused head; each block's conv lays out its spectra with two
    # remaps and its truncation with one
    assert _custom_nodes(served) == Counter({CONTRACT: 7, REMAP: 21})
    with torch.no_grad():  # the artifact serves through forecast as the eager model does
        got = forecast(served, torch.from_numpy(x[..., 0]), 40)
        assert _rel(got, forecast(model, torch.from_numpy(x[..., 0]), 40)) <= 1e-5


class _Block2d(torch.nn.Module):
    """A 2-D operator block on two channel pieces, up-sampling to an even
    last length (a Nyquist plane in the c2r's input)."""

    def __init__(self):
        super().__init__()
        self.block = OperatorBlock(3, 4, (4, 3), normalize=True,
                                   generator=torch.Generator().manual_seed(0))

    def forward(self, x):
        return self.block([x[:, :1], x[:, 1:]], (20, 18))


def test_a_2d_model_exported_before_any_eager_forward_serves_as_eager(tmp_path):
    """A fresh 2-D model, exported before it has run any forward: nothing of
    the FFT path is settled by an eager call first, and the artifact serves
    what the eager model computes."""
    model = _Block2d().eval()
    x = torch.randn((2, 3, 16, 14), generator=torch.Generator().manual_seed(7))
    served = load_forward(export_forward(model, x, path=str(tmp_path / "m.pt2")))
    assert _custom_nodes(served) == Counter({CONTRACT: 1, REMAP: 3})  # a gather a piece
    with torch.no_grad():
        assert _rel(served(x).detach(), model(x)) <= 1e-5


def test_custom_ops_on_the_cpu_are_the_plain_versions():
    g = torch.Generator().manual_seed(3)
    x = torch.complex(torch.randn(3, 4, 10, generator=g), torch.randn(3, 4, 10, generator=g))
    w = torch.complex(torch.randn(4, 5, 10, generator=g), torch.randn(4, 5, 10, generator=g))
    assert torch.equal(torch.ops.uno_tpu_torch.contract(x, w), C.cmul_plain(x, w))
    xh = torch.randn(2, 6, 30, generator=g).bfloat16()
    k1, b1 = torch.randn(6, 8, generator=g), torch.randn(8, generator=g)
    k2, b2 = torch.randn(8, 2, generator=g), torch.randn(2, generator=g)
    got = torch.ops.uno_tpu_torch.mlp_head_fwd(xh, k1, b1, k2, b2)
    assert got.is_contiguous() and torch.equal(got, H.mlp_head_plain(xh, k1, b1, k2, b2))
    # the ops check what the kernels take
    with pytest.raises(TypeError):
        torch.ops.uno_tpu_torch.mlp_head_fwd(xh.float(), k1, b1, k2, b2)
    with pytest.raises(ValueError, match="mismatch"):
        torch.ops.uno_tpu_torch.contract(x, w[:3])


def test_eager_calls_do_not_go_through_the_ops(monkeypatch):
    """Only tracing routes the launches through the custom ops: an eager call
    goes straight to the wrapper (PERF.md §6: the op's dispatch costs host
    time)."""
    called = []
    monkeypatch.setattr(C, "contract", lambda *a: called.append("contract"))
    monkeypatch.setattr(H, "mlp_head_fwd", lambda *a: called.append("head"))
    model = _port("uno9", UNO9, "bfloat16")
    with torch.no_grad():
        model(torch.zeros(1, 85, 85, 1))
    assert called == []


def test_artifact_loads_without_the_model_code(tmp_path):
    """A fresh process imports uno_tpu_torch.export alone (which registers
    the kernels' ops) and serves the artifact; no model-building module is
    imported."""
    model = _port("uno9", UNO9, "bfloat16")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 85, 85, 1))
                         .astype(np.float32))
    path, xp, out = (str(tmp_path / n) for n in ("m.pt2", "x.pt", "y.pt"))
    export_forward(model, x, path=path)
    torch.save(x, xp)
    code = (
        "import sys, torch\n"
        "from uno_tpu_torch.export import load_forward\n"
        f"fn = load_forward({path!r}, device='cpu')\n"
        f"torch.save(fn(torch.load({xp!r})).detach(), {out!r})\n"
        "mods = [m for m in sys.modules if m.startswith(('uno_tpu_torch.models', "
        "'uno_tpu_torch.nn', 'uno_tpu_torch.ops.spectral', 'uno_tpu_torch.train', 'jax', "
        "'flax', 'uno_tpu.'))]\n"
        "assert not mods, mods\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    with torch.no_grad():
        assert torch.equal(torch.load(out), model(x))


def test_move_to_device_pass_cpu_to_cpu():
    model = _port("uno9", UNO9, "float32")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 85, 85, 1))
                         .astype(np.float32))
    moved = load_forward(export_forward(model, x), device=torch.device("cpu"))
    with torch.no_grad():
        assert torch.equal(moved(x), model(x))
    assert all(t.device.type == "cpu" for t in moved.state_dict().values())


def test_cli_export_serves_like_cli_predict(tmp_path, capsys):
    """``cli export`` of a checkpoint-free model (``--init-seed``) at the
    preset's grid, then the artifact against the eager model."""
    import json

    out = str(tmp_path / "darcy.pt2")
    assert cli.main(["export", "--preset", "darcy_s85", "--init-seed", "3", "--dtype",
                     "bfloat16", "--serve-batch", "2", "--out", out, "--device", "cpu"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert lines[-1]["input"] == [2, 85, 85, 1] and lines[-1]["bytes"] == os.path.getsize(out)
    served = load_forward(out)
    preset = cli._build_preset(_Args(preset="darcy_s85", cmd="export"))
    model = cli._model(_Args(dtype="bfloat16"), preset, torch.device("cpu"), seed=3)
    x = torch.randn(2, 85, 85, 1, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        assert torch.equal(served(x), model(x))
    with pytest.raises((AssertionError, RuntimeError), match="Guard|shape"):  # one per shape
        served(torch.zeros(3, 85, 85, 1))


class _Args:
    def __init__(self, **kw):
        self.__dict__.update(kw)

    def __getattr__(self, name):
        return None
