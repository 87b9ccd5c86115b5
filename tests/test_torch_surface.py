"""The port's package surface, ``remat_blocks`` and the head switch.

* The lazy top-level names and the re-exports of ``ops``, ``data``,
  ``train``, ``parallel`` and ``nn``: ``uno_tpu``'s lists, less the names the
  port keeps out on purpose (``KEPT_OUT``, each with its reason).
* ``remat_blocks``: the same output and gradients as without it (bit for
  bit: the recompute runs the same ops on the same inputs), and fewer
  tensors saved for the backward.
* The head switch: the default (the kernel's path for a 2-D bf16 model),
  ``set_fused_head_mode`` and ``UNO_TPU_TORCH_NO_FUSED_HEAD=1``.
"""

import ast
import importlib
import os

import numpy as np
import pytest
import torch

import uno_tpu_torch
from uno_tpu_torch.models import build_model, core
from uno_tpu_torch.ops.kernels import mlp_head

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# uno_tpu's name -> the port's, where the port names it otherwise
RENAMED = {"complex_adam": "ComplexAdam"}
# names of uno_tpu's package __init__s that the port leaves out, and why
KEPT_OUT = {
    "train": {"TrainState": "JAX pytree plumbing (train/state.py); the trainers keep their "
                            "state in the model, the optimizer and a dict",
              "apply_updates": "the same: ComplexAdam.step updates in place"},
    "parallel": {"process_local_batch": "a jax.Array per process; local_rows takes its place",
                 "batch_sharding": "a NamedSharding for device_put; shard_batch takes a rank's "
                                   "rows instead",
                 "replicated": "a NamedSharding for device_put; replicate and place_state "
                               "place the weights instead"},
}
SUBPACKAGES = ("ops", "data", "train", "parallel", "nn")


def _lazy_names() -> list:
    """The names ``uno_tpu/__init__.py``'s ``__getattr__`` serves."""
    tree = ast.parse(open(os.path.join(REPO, "uno_tpu", "__init__.py")).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "__getattr__")
    return sorted({c.value for c in ast.walk(fn) if isinstance(c, ast.Constant)
                   and isinstance(c.value, str) and c.value.isidentifier()
                   and not c.value.startswith("uno_tpu")})


def test_lazy_top_level_names():
    import uno_tpu

    names = _lazy_names()
    assert {"build_model", "TrainConfig", "train_darcy", "relative_lp_loss"} <= set(names)
    for name in names:
        getattr(uno_tpu, name)  # the list is uno_tpu's
        assert getattr(uno_tpu_torch, RENAMED.get(name, name)) is not None, name
    with pytest.raises(AttributeError):
        uno_tpu_torch.not_a_name  # noqa: B018
    from uno_tpu_torch.train import train_darcy  # noqa: F401
    assert uno_tpu_torch.TrainConfig().tensor_parallel is False


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_reexports(sub):
    want = importlib.import_module(f"uno_tpu.{sub}")
    got = importlib.import_module(f"uno_tpu_torch.{sub}")
    kept_out = KEPT_OUT.get(sub, {})
    assert set(kept_out) <= set(want.__all__)
    missing = [n for n in want.__all__ if n not in kept_out and n not in got.__all__]
    assert not missing, missing
    assert not set(kept_out) & set(got.__all__)
    for name in got.__all__:
        assert getattr(got, name) is not None, name


def test_default_modes_match():
    from uno_tpu.ops import spectral as jspec
    from uno_tpu_torch.ops import default_modes_1d, default_modes_2d, default_modes_3d

    for n in (8, 64, 85, 211):
        assert default_modes_1d(n) == jspec.default_modes_1d(n)
        assert default_modes_2d(n, n + 3) == jspec.default_modes_2d(n, n + 3)
        assert default_modes_3d(n, n, 40) == jspec.default_modes_3d(n, n, 40)


def _forward_backward(model, x, y):
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = model(x)
        loss = ((out - y) ** 2).sum()
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return out.detach(), grads, saved


@pytest.mark.parametrize("name,kw,shape", [
    ("uno9", dict(in_width=3, width=8, pad=1), (2, 85, 85, 1)),
    ("uno", dict(in_width=14, width=8, pad=0), (2, 64, 64, 10)),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_blocks_same_output_and_grads(name, kw, shape, dtype):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    outs = []
    for remat in (False, True):
        model = build_model(name, dtype=dtype, remat_blocks=remat,
                            generator=torch.Generator().manual_seed(0), **kw)
        assert model.spec.remat_blocks is remat
        y = torch.zeros(shape[:3] + (1,))
        outs.append(_forward_backward(model, x, y))
    (o0, g0, s0), (o1, g1, s1) = outs
    assert torch.equal(o0, o1)
    assert g0.keys() == g1.keys() and all(torch.equal(g0[k], g1[k]) for k in g0)
    # the forward keeps each block's input instead of its activations
    assert len(s1) < len(s0) and sum(s1) < sum(s0), (len(s1), len(s0), sum(s1), sum(s0))


def test_remat_blocks_saves_nothing_without_grad():
    model = build_model("uno9", remat_blocks=True, generator=torch.Generator().manual_seed(0),
                        in_width=3, width=8, pad=1)
    x = torch.randn(1, 85, 85, 1)
    with torch.no_grad():
        want = build_model("uno9", generator=torch.Generator().manual_seed(0), in_width=3,
                           width=8, pad=1)(x)
        assert torch.equal(model(x), want)


@pytest.fixture
def head_calls(monkeypatch):
    """The model's calls of the fused head (its plain version on the CPU)."""
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return mlp_head.mlp_head(*args)

    monkeypatch.setattr(core, "mlp_head", spy)
    monkeypatch.delenv("UNO_TPU_TORCH_NO_FUSED_HEAD", raising=False)
    yield calls
    mlp_head.set_fused_head_mode(None)


def _uno9(dtype="bfloat16", **over):
    return build_model("uno9", dtype=dtype, generator=torch.Generator().manual_seed(0),
                       in_width=3, width=8, pad=1, **over)


def test_head_switch_default_argument_and_environment(head_calls, monkeypatch):
    x = torch.randn(2, 85, 85, 1)
    model = _uno9()
    with torch.no_grad():
        fused = model(x)
        assert len(head_calls) == 1 and mlp_head.fused_head_enabled()
        _uno9("float32")(x)  # f32: never the kernel
        assert len(head_calls) == 1

        mlp_head.set_fused_head_mode(False)
        assert not mlp_head.fused_head_enabled()
        unfused = model(x)
        assert len(head_calls) == 1
        mlp_head.set_fused_head_mode(None)

        monkeypatch.setenv("UNO_TPU_TORCH_NO_FUSED_HEAD", "1")
        assert not mlp_head.fused_head_enabled()
        assert torch.equal(model(x), unfused) and len(head_calls) == 1
        mlp_head.set_fused_head_mode(True)  # the argument wins over the environment
        assert torch.equal(model(x), fused) and len(head_calls) == 2
    # both heads are f32 (the f32-head contract); they differ only in the
    # order of their f32 sums
    assert fused.dtype == unfused.dtype == torch.float32
    rel = float((fused - unfused).norm() / unfused.norm())
    assert rel < 1e-6, rel
