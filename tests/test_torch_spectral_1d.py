"""The port's 1-D spectral conv and 1-D layers against uno_tpu's.

``spectral_conv_1d`` on the FFT path and on the partial-DFT path (both
packages switched alike), forward and gradients; each path against the
other; the 1-D ``PointwiseOp`` (1x1 conv and a linear, antialiased,
``align_corners=True`` resize through the matrix tables) in both branch
orders and the 1-D ``OperatorBlock``, f32 and bf16, forward and the
gradients of every parameter; the bridge carrying the 1-D parameters.  The
same numpy inputs and the same weights (the port's init, carried to flax by
uno_tpu_torch.bridge) go through both packages on the CPU.  Bounds: rel-L2
<= 1e-5 at f32 for outputs and for the gradients of a real loss
(``jax.grad``'s complex weight gradient conjugated: torch's is its
conjugate); under bf16, 2e-2 (the bf16 bound of
tests/test_torch_spectral_dft.py: bf16 rounds at different points in the
two libraries).  Both hand-written backward passes (the FFT path's
contraction and the DFT path's chain) pass a complex128 ``gradcheck``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uno_tpu.nn import layers as jl
from uno_tpu.ops import spectral as jspec
from uno_tpu_torch import bridge
from uno_tpu_torch.nn import layers as tl
from uno_tpu_torch.ops.spectral import set_dft_mode, spectral_conv_1d

BOUND = {"float32": 1e-5, "bfloat16": 2e-2}
CASES = [
    # (B, Ci, Co, N), out_size, modes
    ((2, 3, 4, 32), 16, 5),    # downsample
    ((2, 3, 2, 16), 33, 9),    # upsample to an odd size; m1 at the input's limit
    ((1, 2, 3, 10), 10, 6),    # m1 = N // 2 + 1: the Nyquist bin is kept
]


def _rel(a, b):
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _inputs(shape, modes, seed=0):
    b, ci, co, n = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, ci, n)).astype(np.float32)
    wshape = (1, ci, co, modes)
    wt = (rng.standard_normal(wshape) + 1j * rng.standard_normal(wshape)).astype(np.complex64)
    return x, wt


@pytest.fixture(params=["fft", "dft"])
def path(request):
    """Both packages on one spectral path."""
    on = request.param == "dft"
    jspec.set_dft_mode(on)
    set_dft_mode(on)
    yield request.param
    jspec.set_dft_mode(None)
    set_dft_mode(None)


@pytest.mark.parametrize("shape,out_size,modes", CASES)
def test_spectral_conv_1d_matches_uno_tpu(shape, out_size, modes, path):
    x, wt = _inputs(shape, modes)
    cot = np.random.default_rng(1).standard_normal((shape[0], shape[2], out_size))
    cot = cot.astype(np.float32)

    def loss(x, w):
        y = jspec.spectral_conv_1d(x, w, out_size, modes)
        return jnp.sum(y * jnp.asarray(cot)), y

    (jgx, jgw), want = jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(x), jnp.asarray(wt))
    xt = torch.from_numpy(x).requires_grad_()
    wtt = torch.from_numpy(wt).requires_grad_()
    got = spectral_conv_1d(xt, wtt, out_size, modes)
    (got * torch.from_numpy(cot)).sum().backward()
    assert got.dtype == torch.float32 and got.shape == want.shape == (shape[0], shape[2],
                                                                       out_size)
    assert _rel(got.detach().numpy(), want) <= 1e-5, _rel(got.detach().numpy(), want)
    assert _rel(xt.grad.numpy(), jgx) <= 1e-5, _rel(xt.grad.numpy(), jgx)
    assert _rel(wtt.grad.numpy(), np.conj(np.asarray(jgw))) <= 1e-5


def test_spectral_conv_1d_bf16_on_the_dft_path_matches_uno_tpu():
    """A bf16 input stays bf16 on the DFT path (f32 accumulation), as in
    uno_tpu; the weight gradient is f32 sums of bf16 products."""
    shape, out_size, modes = CASES[0]
    x, wt = _inputs(shape, modes, seed=2)
    cot = np.random.default_rng(3).standard_normal((shape[0], shape[2], out_size))
    cot = cot.astype(np.float32)
    jspec.set_dft_mode(True)
    set_dft_mode(True)
    try:
        def loss(x, w):
            y = jspec.spectral_conv_1d(x, w, out_size, modes)
            return jnp.sum(y.astype(jnp.float32) * jnp.asarray(cot)), y

        (jgx, jgw), want = jax.grad(loss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt))
        xt = torch.from_numpy(x).bfloat16().requires_grad_()
        wtt = torch.from_numpy(wt).requires_grad_()
        got = spectral_conv_1d(xt, wtt, out_size, modes)
        (got.float() * torch.from_numpy(cot)).sum().backward()
    finally:
        jspec.set_dft_mode(None)
        set_dft_mode(None)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert xt.grad.dtype == torch.bfloat16 and wtt.grad.dtype == torch.complex64
    for g, w in ((got.detach(), want), (xt.grad, jgx)):
        assert _rel(g.float().numpy(), np.asarray(w, np.float32)) <= BOUND["bfloat16"]
    assert _rel(wtt.grad.numpy(), np.conj(np.asarray(jgw))) <= BOUND["bfloat16"]


@pytest.mark.parametrize("shape,out_size,modes", CASES)
def test_dft_path_matches_the_fft_path_1d(shape, out_size, modes):
    x, wt = _inputs(shape, modes, seed=4)
    cot = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (shape[0], shape[2], out_size)).astype(np.float32))
    results = []
    for mode in (False, True):
        set_dft_mode(mode)
        try:
            xt = torch.from_numpy(x).requires_grad_()
            wtt = torch.from_numpy(wt).requires_grad_()
            y = spectral_conv_1d(xt, wtt, out_size, modes)
            (y * cot).sum().backward()
        finally:
            set_dft_mode(None)
        results.append((y.detach(), xt.grad, wtt.grad))
    for got, want in zip(results[1], results[0]):
        assert _rel(got.numpy(), want.numpy()) <= 1e-5, _rel(got.numpy(), want.numpy())


@pytest.mark.parametrize("n,out_size,modes", [(8, 6, 3), (7, 11, 4), (6, 6, 4)])
def test_spectral_conv_1d_gradcheck_complex128(n, out_size, modes, path):
    """torch's complex convention for the weight's gradient on both paths:
    gradcheck differentiates the real and imaginary parts separately, so a
    conjugated (JAX-convention) gradient fails it."""
    g = torch.Generator().manual_seed(6)
    x = torch.randn((2, 2, n), generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn((1, 2, 3, modes), generator=g, dtype=torch.complex128, requires_grad=True)
    assert torch.autograd.gradcheck(lambda x, w: spectral_conv_1d(x, w, out_size, modes),
                                    (x, w))


def test_spectral_conv_1d_modes_beyond_the_grid_raise(path):
    x, wt = _inputs((1, 2, 2, 16), 10)
    with pytest.raises(ValueError, match="modes1=10"):  # > 16 // 2 + 1
        spectral_conv_1d(torch.from_numpy(x), torch.from_numpy(wt), 32, 10)
    x, wt = _inputs((1, 2, 2, 32), 6)
    with pytest.raises(ValueError, match="modes1=6"):  # > 8 // 2 + 1
        spectral_conv_1d(torch.from_numpy(x), torch.from_numpy(wt), 8, 6)


def _flax(module):
    return jax.tree.map(jnp.asarray, bridge.params_to_flax(module))


def _grads(module):
    """The module's gradients keyed by flax path, in flax's layout."""
    out = {}
    for name, p in module.named_parameters():
        fpath, transpose = bridge._flax_path(name)
        g = p.grad.detach().numpy()
        out[fpath] = g.T if transpose else g
    return out


def _flat(tree):
    tree = tree["params"] if "params" in tree else tree
    return {tuple(k.key for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_leaves_with_path(tree)}


def _layer_case(tm, jm, x, out, dtype):
    """Forward and the gradients of every parameter of a real loss, port
    against uno_tpu; returns the port's output."""
    cot = np.random.default_rng(7).standard_normal(
        (x.shape[0], tm.out_codim if hasattr(tm, "out_codim") else tm.conv.weights.shape[2],
         out[0])).astype(np.float32)
    xj = jnp.asarray(x, dtype)

    def loss(p):
        y = jm.apply(p, xj, out)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(cot)), y

    jg, want = jax.jit(jax.grad(loss, has_aux=True))(_flax(tm))
    got = tm(torch.from_numpy(x).to(getattr(torch, dtype)), out)
    (got.float() * torch.from_numpy(cot)).sum().backward()
    assert str(got.dtype) == f"torch.{dtype}" and want.dtype == jnp.dtype(dtype)
    assert got.shape == want.shape == (x.shape[0], cot.shape[1]) + out
    rel = _rel(got.detach().float().numpy(), np.asarray(want, np.float32))
    assert rel <= BOUND[dtype], rel
    grads, wants = _grads(tm), _flat(jg)
    assert set(grads) == set(wants)
    total = np.sqrt(sum(np.linalg.norm(w) ** 2 for w in wants.values()))
    for k, g in grads.items():
        w = np.conj(np.asarray(wants[k]))  # a no-op on real leaves
        if k == ("w", "bias") and getattr(tm, "normalize", False):
            # the norm cancels a per-channel constant: zero up to rounding,
            # held absolutely at the dtype's bound of the whole gradient
            assert max(np.linalg.norm(g), np.linalg.norm(w)) <= BOUND[dtype] * total, k
            continue
        assert _rel(g, w) <= BOUND[dtype], (k, _rel(g, w))
    return got


# the resize-or-conv-first rule: downsampling with Ci < Co resizes first,
# upsampling with Ci > Co convolves first
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ci,co,n,out", [(3, 6, 40, 17), (6, 3, 12, 31), (4, 4, 20, 20)])
def test_pointwise_op_1d_matches_uno_tpu(ci, co, n, out, dtype):
    x = np.random.default_rng(8).standard_normal((2, ci, n)).astype(np.float32)
    tm = tl.PointwiseOp(ci, co, getattr(torch, dtype), generator=torch.Generator().manual_seed(0))
    jm = jl.PointwiseOp(ci, co, 1, dtype=jnp.dtype(dtype))
    _layer_case(tm, jm, x, (out,), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("normalize,ci,co,n,out,modes", [
    (True, 4, 8, 48, 24, 7),      # encoder
    (False, 8, 4, 16, 40, 9),     # decoder
])
def test_operator_block_1d_matches_uno_tpu(normalize, ci, co, n, out, modes, dtype, path):
    x = np.random.default_rng(9).standard_normal((2, ci, n)).astype(np.float32)
    tm = tl.OperatorBlock(ci, co, (modes,), normalize, dtype=getattr(torch, dtype),
                          generator=torch.Generator().manual_seed(1))
    assert tm.conv.weights.shape == (1, ci, co, modes)
    if normalize:  # a non-trivial affine
        with torch.no_grad():
            tm.norm_scale.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(2))
            tm.norm_bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(3))
    jm = jl.OperatorBlock(ci, co, (modes,), normalize=normalize, dtype=jnp.dtype(dtype))
    _layer_case(tm, jm, x, (out,), dtype)


def test_bridge_carries_a_1d_block_both_ways():
    """The 1-D parameter names and shapes are uno_tpu's (its init's tree
    from ``jax.eval_shape``); a round trip is bit-exact."""
    tm = tl.OperatorBlock(3, 5, (6,), True, generator=torch.Generator().manual_seed(4))
    jm = jl.OperatorBlock(3, 5, (6,), normalize=True)
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x, (20,)),
                            jnp.zeros((1, 3, 24), jnp.float32))
    want = {tuple(k.key for k in kp): tuple(v.shape)
            for kp, v in jax.tree_util.tree_leaves_with_path(shapes["params"])}
    assert {k: v.shape for k, v in _flat(bridge.params_to_flax(tm)).items()} == want
    assert want[("conv", "weights")] == (1, 3, 5, 6)
    again = bridge.params_from_flax(
        tl.OperatorBlock(3, 5, (6,), True, generator=torch.Generator().manual_seed(5)),
        bridge.params_to_flax(tm))
    for (k, a), b in zip(tm.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
