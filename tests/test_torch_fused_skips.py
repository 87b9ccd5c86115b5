"""Skip concats carried as channel pieces in the port (models/core.py
``fused_skips``) against the materialized concat and against uno_tpu's
tuples (uno_tpu/models/core.py).

A 2-D model under f32 carries each skip concat as a list of channel pieces;
the spectral conv and the 1x1 conv contract each piece against its own
input rows of the same weights.  By linearity that is the concatenated
computation, so the port's two forms must agree to rounding, and the port
fused must agree with uno_tpu fused (its f32 default).  Bounds: uno_tpu's
own for fused against materialized (tests/test_fused_skips.py: loss rtol
2e-6, gradients rtol 2e-4 and atol 2e-6; under bf16 2e-2), the same for
the port against uno_tpu, and rel-L2 1e-4 for the output
(tests/test_torch_model.py).  uno9 and uno11 at width 8 on 88x88, batch 2,
the same weights on both sides through ``uno_tpu_torch.bridge`` (the port's
init carried into a flax tree: a flax init would compile for ~10 s).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import _flat_tree, _port_grads
from uno_tpu.losses import relative_lp_loss as j_relative_lp_loss
from uno_tpu.models import build_model as jax_build_model
from uno_tpu.ops import spectral as jspectral
from uno_tpu_torch import bridge
from uno_tpu_torch.losses import relative_lp_loss
from uno_tpu_torch.models import build_model
from uno_tpu_torch.models.core import fused_skips
from uno_tpu_torch.nn.layers import OperatorBlock, PointwiseOp
from uno_tpu_torch.ops import spectral

S, KW = 88, dict(in_width=3, width=8, pad=1)
MODELS = ["uno9", "uno11"]
PATHS = ["fft", "dft"]
ENV = ("UNO_TPU_TORCH_FUSED_SKIPS", "UNO_TPU_TORCH_NO_FUSED_SKIPS")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, S, S, 1)).astype(np.float32),
            rng.standard_normal((2, S, S, 1)).astype(np.float32))


@contextlib.contextmanager
def _dft(path):
    spectral.set_dft_mode(path == "dft")
    try:
        yield
    finally:
        spectral.set_dft_mode(None)


def _port_run(name, tree, fuse: bool, path: str):
    """The port's output, loss and gradients (flax's layout) with the skips
    fused or materialized."""
    x, y = _data()
    model = bridge.params_from_flax(
        build_model(name, generator=torch.Generator().manual_seed(1), **KW), tree)
    with pytest.MonkeyPatch.context() as mp, _dft(path):
        for k in ENV:
            mp.delenv(k, raising=False)
        if not fuse:
            mp.setenv("UNO_TPU_TORCH_NO_FUSED_SKIPS", "1")
        out = model(torch.from_numpy(x))
        loss = relative_lp_loss(out.reshape(y.shape), torch.from_numpy(y), reduction="sum")
        loss.backward()
    return out.detach().numpy(), loss.item(), _port_grads(model)


@pytest.fixture(scope="module")
def runs():
    """Per (model, path): uno_tpu's output, loss and gradients, fused (its
    f32 default carries the skips as tuples), then the port's fused and
    materialized, from the same weights.  uno_tpu's gradient is compiled
    at XLA's backend optimization level 0, which changes no HLO and
    compiles ~4x faster."""
    x, y = _data()
    out = {}
    for name in MODELS:
        jm = jax_build_model(name, **KW)
        tree = bridge.params_to_flax(
            build_model(name, generator=torch.Generator().manual_seed(0), **KW))

        def loss_fn(p, jm=jm):
            pred = jm.apply(p, jnp.asarray(x))
            return j_relative_lp_loss(pred.reshape(y.shape), jnp.asarray(y), reduction="sum"), pred

        for path in PATHS:
            jspectral.set_dft_mode(path == "dft")
            try:
                step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(tree).compile(
                    compiler_options={"xla_backend_optimization_level": 0})
                (loss, pred), grads = step(tree)
            finally:
                jspectral.set_dft_mode(None)
            out[name, path] = dict(
                uno_tpu=(np.asarray(pred), float(loss), _flat_tree(grads)),
                fused=_port_run(name, tree, True, path),
                materialized=_port_run(name, tree, False, path))
    return out


def _assert_grads(got, want, conj_want: bool):
    assert set(got) == set(want)
    for k, g in got.items():
        w = np.conj(want[k]) if conj_want else want[k]  # jax.grad's is the conjugate of torch's
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-6, err_msg=str(k))


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("name", MODELS)
def test_fused_matches_materialized(name, path, runs):
    (out_f, loss_f, grads_f), (out_m, loss_m, grads_m) = (
        runs[name, path][k] for k in ("fused", "materialized"))
    assert _rel(out_f, out_m) <= 1e-5, _rel(out_f, out_m)
    np.testing.assert_allclose(loss_f, loss_m, rtol=2e-6)
    _assert_grads(grads_f, grads_m, conj_want=False)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("name", MODELS)
def test_fused_matches_uno_tpu_fused(name, path, runs):
    (out, loss, grads), (out_j, loss_j, grads_j) = (
        runs[name, path][k] for k in ("fused", "uno_tpu"))
    assert out.shape == out_j.shape == (2, S, S, 1)
    assert _rel(out, out_j) <= 1e-4, _rel(out, out_j)
    np.testing.assert_allclose(loss, loss_j, rtol=2e-6)
    _assert_grads(grads, grads_j, conj_want=True)


def _real_cats(model, x, monkeypatch):
    """The shapes of the real tensors that ``torch.cat`` writes in a forward
    (the mode corners are complex)."""
    cats, cat = [], torch.cat

    def record(tensors, *args, **kw):
        out = cat(tensors, *args, **kw)
        if not out.is_complex():
            cats.append(tuple(out.shape))
        return out

    monkeypatch.setattr(torch, "cat", record)
    with torch.no_grad():
        model(x)
    monkeypatch.setattr(torch, "cat", cat)
    return cats


def test_f32_forward_writes_no_full_grid_concat(monkeypatch):
    """Fused, the only real concatenations are the grid embedding's (its
    coordinates, then the input's channels) and the last block's cropped
    pieces; materialized, block 3's skip concat at 45x45 is written too."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    w = KW["width"]
    model = build_model("uno9", generator=torch.Generator().manual_seed(0), **KW)
    x = torch.from_numpy(_data()[0])
    fused = [(2, S, S, 2), (2, S, S, 3), (2, 2 * w, S, S)]
    assert _real_cats(model, x, monkeypatch) == fused
    monkeypatch.setenv("UNO_TPU_TORCH_NO_FUSED_SKIPS", "1")
    assert _real_cats(model, x, monkeypatch) == fused[:2] + [(2, 4 * w, 45, 45), fused[2]]


def test_gate_follows_uno_tpu(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    assert fused_skips(2, torch.float32) and not fused_skips(2, torch.bfloat16)
    assert not fused_skips(3, torch.float32) and not fused_skips(1, torch.float32)
    monkeypatch.setenv("UNO_TPU_TORCH_FUSED_SKIPS", "1")
    assert fused_skips(2, torch.bfloat16) and not fused_skips(3, torch.bfloat16)
    monkeypatch.setenv("UNO_TPU_TORCH_NO_FUSED_SKIPS", "1")
    assert not fused_skips(2, torch.float32) and not fused_skips(2, torch.bfloat16)


def test_bf16_defaults_to_materialized_and_forced_matches(monkeypatch):
    """uno_tpu's tests/test_fused_skips.py:60-87 in the port: under bf16 the
    default is the materialized form bit for bit; forced on, within 2e-2."""
    model = build_model("uno9", dtype="bfloat16", generator=torch.Generator().manual_seed(0),
                        **KW)
    x = torch.from_numpy(_data(2)[0])

    def run(**env):
        for k in ENV:
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        with torch.no_grad():
            return model(x).float().numpy()

    y_default = run()
    y_mat = run(UNO_TPU_TORCH_NO_FUSED_SKIPS="1")
    np.testing.assert_array_equal(y_default, y_mat)
    y_fused = run(UNO_TPU_TORCH_FUSED_SKIPS="1")
    np.testing.assert_allclose(y_fused, y_mat, rtol=2e-2, atol=2e-2)


def test_3d_never_fuses(monkeypatch):
    """uno3d_t10 at width 2 on 32x32x10: the same bits with the switch
    forced either way, and every block takes one tensor."""
    model = build_model("uno3d_t10", in_width=6, width=2, pad=2,
                        generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 32, 32, 10, 1))
                         .astype(np.float32))
    inputs = []
    hooks = [b.register_forward_pre_hook(lambda m, a: inputs.append(type(a[0])))
             for n, b in model.named_children() if n.startswith("block")]
    outs = []
    for env in ("UNO_TPU_TORCH_FUSED_SKIPS", "UNO_TPU_TORCH_NO_FUSED_SKIPS"):
        for k in ENV:
            monkeypatch.delenv(k, raising=False)
        monkeypatch.setenv(env, "1")
        with torch.no_grad():
            outs.append(model(x))
    for h in hooks:
        h.remove()
    assert torch.equal(outs[0], outs[1])
    assert set(inputs) == {torch.Tensor}


def test_parameters_are_the_same_in_both_forms(monkeypatch):
    states = []
    for env in ENV:
        for k in ENV:
            monkeypatch.delenv(k, raising=False)
        monkeypatch.setenv(env, "1")
        states.append(build_model("uno11", generator=torch.Generator().manual_seed(0),
                                  **KW).state_dict())
    assert list(states[0]) == list(states[1])
    for k, v in states[0].items():
        assert torch.equal(v, states[1][k]), k


def test_remat_blocks_with_pieces_is_bit_for_bit(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    x, y = (torch.from_numpy(a[:1]) for a in _data(3))
    runs = []
    for remat in (False, True):
        model = build_model("uno9", remat_blocks=remat,
                            generator=torch.Generator().manual_seed(0), **KW)
        out = model(x)
        relative_lp_loss(out.reshape(y.shape), y, reduction="sum").backward()
        runs.append((out.detach(), {n: p.grad for n, p in model.named_parameters()}))
    assert torch.equal(runs[0][0], runs[1][0])
    for n, g in runs[0][1].items():
        assert torch.equal(g, runs[1][1][n]), n


def test_residual_block_refuses_pieces():
    block = OperatorBlock(8, 8, (4, 4), residual=True, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="residual"):
        block([torch.zeros(1, 4, 16, 16), torch.zeros(1, 4, 16, 16)], (16, 16))


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("out", [(12, 12), (32, 32)])  # PointwiseOp: resize first / conv first
def test_layers_take_pieces_as_the_concat(path, out):
    """The 2-D conv and the 1x1 conv on pieces of 3 + 5 channels against the
    concatenated input, float64, forward and every gradient."""
    g = torch.Generator().manual_seed(0)
    pieces = [torch.randn(2, c, 20, 20, generator=g, dtype=torch.float64, requires_grad=True)
              for c in (3, 5)]
    weights = spectral.spectral_weight_init(8, 6, (4, 4), 2, g).to(torch.complex128)
    weights.requires_grad_(True)
    pw = PointwiseOp(8, 6, torch.float64, generator=g).double()
    cot = torch.randn(2, 6, *out, generator=g, dtype=torch.float64)
    res = []
    with _dft(path):
        for x in (pieces, torch.cat(pieces, dim=1)):
            y = spectral.spectral_conv_2d(x, weights, out, (4, 4)) + pw(x, out)
            grads = torch.autograd.grad((y * cot).sum(), [*pieces, weights, *pw.parameters()])
            res.append((y.detach(), grads))
    torch.testing.assert_close(res[0][0], res[1][0], rtol=1e-12, atol=1e-12)
    for a, b in zip(res[0][1], res[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
