"""The port's 3-D spectral ops and 3-D layers against uno_tpu's.

``spectral_conv_3d`` and ``fourier_truncate_3d`` on the FFT path (uno_tpu's
default off the TPU) and on the partial-DFT path (both packages under
``set_dft_mode(True)``), forward and gradients, and each DFT op against the
port's FFT path; the 3-D ``PointwiseOp`` (the
truncation, then an identity trilinear resize) and ``OperatorBlock`` in
both branch orders of the resize-or-conv-first rule, f32 and bf16, with the
output dtype of each; ``grid_sincos_3d``.  The same numpy inputs and the
same weights (the port's init, carried to flax by uno_tpu_torch.bridge) go
through both packages on the CPU.  Bounds: rel-L2 <= 1e-5 at f32 (the two
FFT libraries sum in different orders), for the outputs and for the
gradients of a real loss (``jax.grad``'s complex weight gradient
conjugated: torch's is its conjugate); under bf16 one bf16 rounding
(2**-8), as the 2-D layer tests; on the DFT path under bf16, where every
stage rounds to bf16 in each package at different points, rel-L2 <= 2e-2,
the bf16 bound of tests/test_torch_spectral_dft.py.  Each hand-written
DFT backward passes a float64 / complex128 ``gradcheck``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uno_tpu.models import embeddings as jemb
from uno_tpu.nn import layers as jl
from uno_tpu.ops import spectral as jspec
from uno_tpu_torch import bridge
from uno_tpu_torch.models import embeddings as temb
from uno_tpu_torch.nn import layers as tl
from uno_tpu_torch.ops.spectral import fourier_truncate_3d, set_dft_mode, spectral_conv_3d
from _threads import worker_share_of_threads  # noqa: F401,E402

CONV_CASES = [
    # (B, Ci, Co, X, Y, T), out_size, modes
    ((2, 3, 4, 16, 16, 10), (12, 12, 10), (4, 4, 3)),   # downsample in space
    ((2, 3, 2, 12, 10, 8), (14, 10, 19), (5, 4, 3)),    # upsample, odd time
    ((1, 2, 3, 12, 12, 8), (8, 10, 8), (6, 6, 3)),      # 2*m > d on kx and on ky
    ((1, 2, 2, 8, 8, 9), (8, 8, 9), (3, 3, 5)),         # m3 at its limit d3 // 2 + 1
    ((1, 2, 3, 8, 8, 6), (12, 12, 6), (6, 6, 3)),       # 2*m > X and Y: the input corners overlap
]
TRUNC_CASES = [
    ((2, 3, 12, 10, 8), (6, 5, 4)),     # down on every axis
    ((2, 3, 8, 10, 6), (12, 14, 9)),    # up on every axis
    ((1, 2, 9, 12, 7), (12, 6, 7)),     # x up, y down, t kept
]


def _rel(a, b):
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _conv_inputs(shape, modes, seed=0):
    b, ci, co, *grid = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, ci, *grid)).astype(np.float32)
    wshape = (4, ci, co) + tuple(modes)
    wt = (rng.standard_normal(wshape) + 1j * rng.standard_normal(wshape)).astype(np.complex64)
    return x, wt


@pytest.fixture
def jax_fft():
    jspec.set_dft_mode(False)
    yield
    jspec.set_dft_mode(None)


@pytest.mark.parametrize("shape,out_size,modes", CONV_CASES)
def test_spectral_conv_3d_matches_uno_tpu(shape, out_size, modes, jax_fft):
    x, wt = _conv_inputs(shape, modes)
    want = np.asarray(jax.jit(lambda a, w: jspec.spectral_conv_3d(a, w, out_size, modes))(
        jnp.asarray(x), jnp.asarray(wt)))
    got = spectral_conv_3d(torch.from_numpy(x), torch.from_numpy(wt), out_size, modes)
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (shape[0], shape[2]) + out_size
    assert _rel(got.numpy(), want) <= 1e-5, _rel(got.numpy(), want)


@pytest.mark.parametrize("shape,out_size,modes", CONV_CASES)
def test_spectral_conv_3d_gradients_match_uno_tpu(shape, out_size, modes, jax_fft):
    x, wt = _conv_inputs(shape, modes, seed=1)
    cot = np.random.default_rng(2).standard_normal((shape[0], shape[2]) + out_size)
    cot = cot.astype(np.float32)

    def loss(x, wt):
        return jnp.sum(jspec.spectral_conv_3d(x, wt, out_size, modes) * jnp.asarray(cot))

    jgx, jgw = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(wt))
    xt = torch.from_numpy(x).requires_grad_()
    wtt = torch.from_numpy(wt).requires_grad_()
    (spectral_conv_3d(xt, wtt, out_size, modes) * torch.from_numpy(cot)).sum().backward()
    assert _rel(xt.grad.numpy(), jgx) <= 1e-5, _rel(xt.grad.numpy(), jgx)
    assert _rel(wtt.grad.numpy(), np.conj(np.asarray(jgw))) <= 1e-5
    (d1, d2, _), (m1, m2, _) = out_size, modes
    if 2 * m1 > d1:
        # the positive-kx rows that the negative-kx blocks overwrite get no gradient
        assert torch.all(wtt.grad[[0, 2], :, :, d1 - m1:] == 0)
        assert torch.any(wtt.grad[[0, 2], :, :, : d1 - m1] != 0)
    if 2 * m2 > d2:
        assert torch.all(wtt.grad[[0, 1], :, :, :, d2 - m2:] == 0)


def test_spectral_conv_3d_gradcheck_complex128():
    """float64 input and complex128 weights stay in double precision."""
    x, wt = _conv_inputs((1, 1, 1, 4, 4, 4), (2, 2, 2), seed=3)
    xt = torch.from_numpy(x).double().requires_grad_()
    wtt = torch.from_numpy(wt).to(torch.complex128).requires_grad_()
    # out (5, 3, 6): 2 * m2 > d2, the ky quadrants overlap
    assert torch.autograd.gradcheck(lambda a, w: spectral_conv_3d(a, w, (5, 3, 6), (2, 2, 2)),
                                    (xt, wtt))


@pytest.mark.parametrize("shape,out_size", TRUNC_CASES)
def test_fourier_truncate_3d_matches_uno_tpu(shape, out_size, jax_fft):
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    cot = np.random.default_rng(5).standard_normal(shape[:2] + out_size).astype(np.float32)

    def loss(a):
        y = jspec.fourier_truncate_3d(a, out_size)
        return jnp.sum(y * jnp.asarray(cot)), y

    jgx, want = jax.jit(jax.grad(loss, has_aux=True))(jnp.asarray(x))
    want = np.asarray(want)
    xt = torch.from_numpy(x).requires_grad_()
    got = fourier_truncate_3d(xt, out_size)
    (got * torch.from_numpy(cot)).sum().backward()
    assert got.dtype == torch.float32 and got.shape == want.shape == shape[:2] + out_size
    assert _rel(got.detach().numpy(), want) <= 1e-5, _rel(got.detach().numpy(), want)
    assert _rel(xt.grad.numpy(), jgx) <= 1e-5, _rel(xt.grad.numpy(), jgx)
    # f32 out whatever the input dtype: the 3-D PointwiseOp's dtype flow needs it
    got16 = fourier_truncate_3d(torch.from_numpy(x).bfloat16(), out_size)
    assert got16.dtype == torch.float32
    assert torch.equal(got16, fourier_truncate_3d(torch.from_numpy(x).bfloat16().float(),
                                                  out_size))


def test_3d_ops_raise_on_the_dft_path(monkeypatch):
    """The DFT switch, by the setter and by the environment, runs both 3-D
    ops on the partial-DFT path (they raised before it was ported; the
    name is kept): a bf16 input stays bf16 there, and the results match
    uno_tpu's DFT path."""
    x, wt = _conv_inputs((1, 2, 2, 8, 8, 6), (3, 3, 2))
    xb, w = torch.from_numpy(x).bfloat16(), torch.from_numpy(wt)
    jspec.set_dft_mode(True)
    try:
        want_c = np.asarray(jspec.spectral_conv_3d(jnp.asarray(x), jnp.asarray(wt), (8, 8, 6),
                                                   (3, 3, 2)))
        want_t = np.asarray(jspec.fourier_truncate_3d(jnp.asarray(x), (4, 4, 6)))
    finally:
        jspec.set_dft_mode(None)
    set_dft_mode(True)
    try:
        assert spectral_conv_3d(xb, w, (8, 8, 6), (3, 3, 2)).dtype == torch.bfloat16
        got_t = fourier_truncate_3d(torch.from_numpy(x), (4, 4, 6))
    finally:
        set_dft_mode(None)
    assert _rel(got_t.numpy(), want_t) <= 1e-5
    monkeypatch.setenv("UNO_TPU_TORCH_DFT", "1")
    got_c = spectral_conv_3d(torch.from_numpy(x), w, (8, 8, 6), (3, 3, 2))
    assert _rel(got_c.numpy(), want_c) <= 1e-5
    assert fourier_truncate_3d(xb, (4, 4, 6)).dtype == torch.bfloat16
    monkeypatch.delenv("UNO_TPU_TORCH_DFT")
    assert spectral_conv_3d(xb, w, (8, 8, 6), (3, 3, 2)).dtype == torch.float32  # FFT


DFT_BOUND = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture
def dft_mode():
    jspec.set_dft_mode(True)
    set_dft_mode(True)
    yield
    jspec.set_dft_mode(None)
    set_dft_mode(None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,out_size,modes", CONV_CASES)
def test_dft_conv_3d_matches_uno_tpu(dft_mode, shape, out_size, modes, dtype):
    x, wt = _conv_inputs(shape, modes)
    want = jax.jit(lambda a, w: jspec.spectral_conv_3d(a, w, out_size, modes))(
        jnp.asarray(x, dtype), jnp.asarray(wt))
    got = spectral_conv_3d(torch.from_numpy(x).to(getattr(torch, dtype)),
                           torch.from_numpy(wt), out_size, modes)
    assert str(got.dtype) == f"torch.{dtype}" and want.dtype == jnp.dtype(dtype)
    assert got.shape == want.shape == (shape[0], shape[2]) + out_size
    rel = _rel(got.float().numpy(), np.asarray(want, np.float32))
    assert rel <= DFT_BOUND[dtype], rel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,out_size,modes", CONV_CASES[:3])
def test_dft_conv_3d_gradients_match_uno_tpu(dft_mode, shape, out_size, modes, dtype):
    x, wt = _conv_inputs(shape, modes, seed=1)
    cot = np.random.default_rng(2).standard_normal((shape[0], shape[2]) + out_size)
    cot = cot.astype(np.float32)

    def loss(x, wt):
        y = jspec.spectral_conv_3d(x, wt, out_size, modes)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(cot))

    jgx, jgw = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(x, dtype), jnp.asarray(wt))
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    wtt = torch.from_numpy(wt).requires_grad_()
    (spectral_conv_3d(xt, wtt, out_size, modes).float() * torch.from_numpy(cot)).sum().backward()
    assert xt.grad.dtype == xt.dtype and wtt.grad.dtype == torch.complex64
    rx = _rel(xt.grad.float().numpy(), np.asarray(jgx, np.float32))
    rw = _rel(wtt.grad.numpy(), np.conj(np.asarray(jgw)))
    assert rx <= DFT_BOUND[dtype] and rw <= DFT_BOUND[dtype], (rx, rw)
    (d1, d2, _), (m1, m2, _) = out_size, modes
    if 2 * m1 > d1:  # overwritten positive-kx rows get no gradient, as on the FFT path
        assert torch.all(wtt.grad[[0, 2], :, :, d1 - m1:] == 0)
    if 2 * m2 > d2:
        assert torch.all(wtt.grad[[0, 1], :, :, :, d2 - m2:] == 0)


@pytest.mark.parametrize("shape,out_size,modes", CONV_CASES)
def test_dft_conv_3d_matches_the_fft_path(shape, out_size, modes):
    x, wt = _conv_inputs(shape, modes, seed=3)
    cot = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (shape[0], shape[2]) + out_size).astype(np.float32))
    results = []
    for mode in (False, True):
        set_dft_mode(mode)
        try:
            xt = torch.from_numpy(x).requires_grad_()
            wtt = torch.from_numpy(wt).requires_grad_()
            y = spectral_conv_3d(xt, wtt, out_size, modes)
            (y * cot).sum().backward()
        finally:
            set_dft_mode(None)
        results.append((y.detach(), xt.grad, wtt.grad))
    for got, want in zip(results[1], results[0]):
        assert _rel(got.numpy(), want.numpy()) <= 1e-5, _rel(got.numpy(), want.numpy())


def test_dft_conv_3d_gradcheck_complex128(dft_mode):
    """torch's complex convention for the weight's gradient on the
    hand-written backward (a conjugated one fails gradcheck)."""
    x, wt = _conv_inputs((1, 1, 2, 4, 4, 4), (2, 2, 2), seed=5)
    xt = torch.from_numpy(x).double().requires_grad_()
    w = torch.from_numpy(wt).to(torch.complex128).requires_grad_()
    # out (5, 3, 6): 2 * m2 > d2, the ky quadrants overlap
    assert torch.autograd.gradcheck(lambda a, w: spectral_conv_3d(a, w, (5, 3, 6), (2, 2, 2)),
                                    (xt, w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,out_size", TRUNC_CASES)
def test_dft_truncate_3d_matches_uno_tpu(dft_mode, shape, out_size, dtype):
    """The kept bins stay at their original indices (no relocation when the
    input is smaller than the output), the backward norm, and the dtype
    rule of the DFT path."""
    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    cot = np.random.default_rng(7).standard_normal(shape[:2] + out_size).astype(np.float32)

    def loss(a):
        y = jspec.fourier_truncate_3d(a, out_size)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(cot)), y

    jgx, want = jax.jit(jax.grad(loss, has_aux=True))(jnp.asarray(x, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    got = fourier_truncate_3d(xt, out_size)
    (got.float() * torch.from_numpy(cot)).sum().backward()
    assert str(got.dtype) == f"torch.{dtype}" and want.dtype == jnp.dtype(dtype)
    assert got.shape == want.shape == shape[:2] + out_size
    ro = _rel(got.detach().float().numpy(), np.asarray(want, np.float32))
    rx = _rel(xt.grad.float().numpy(), np.asarray(jgx, np.float32))
    assert ro <= DFT_BOUND[dtype] and rx <= DFT_BOUND[dtype], (ro, rx)


@pytest.mark.parametrize("shape,out_size", TRUNC_CASES)
def test_dft_truncate_3d_matches_the_fft_path(shape, out_size):
    x = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    cot = torch.from_numpy(np.random.default_rng(9).standard_normal(shape[:2] + out_size)
                           .astype(np.float32))
    results = []
    for mode in (False, True):
        set_dft_mode(mode)
        try:
            xt = torch.from_numpy(x).requires_grad_()
            y = fourier_truncate_3d(xt, out_size)
            (y * cot).sum().backward()
        finally:
            set_dft_mode(None)
        results.append((y.detach(), xt.grad))
    for got, want in zip(results[1], results[0]):
        assert _rel(got.numpy(), want.numpy()) <= 1e-5, _rel(got.numpy(), want.numpy())


@pytest.mark.parametrize("shape,out_size", [((1, 1, 6, 5, 4), (4, 3, 4)),
                                            ((1, 1, 3, 4, 5), (6, 5, 8))])
def test_dft_truncate_3d_gradcheck_float64(dft_mode, shape, out_size):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(10), dtype=torch.float64,
                    requires_grad=True)
    assert torch.autograd.gradcheck(lambda a: fourier_truncate_3d(a, out_size), (x,))


def test_spectral_conv_3d_modes_beyond_the_grid_raise():
    x, wt = _conv_inputs((1, 2, 2, 8, 8, 6), (3, 3, 5))
    with pytest.raises(ValueError, match="modes"):  # m3 > 6 // 2 + 1
        spectral_conv_3d(torch.from_numpy(x), torch.from_numpy(wt), (8, 8, 12), (3, 3, 5))
    x, wt = _conv_inputs((1, 2, 2, 8, 8, 6), (9, 3, 2))
    with pytest.raises(ValueError, match="modes"):  # m1 > X
        spectral_conv_3d(torch.from_numpy(x), torch.from_numpy(wt), (12, 8, 6), (9, 3, 2))


def test_grid_sincos_3d_matches_uno_tpu():
    want = np.asarray(jemb.grid_sincos_3d((2, 13, 21, 7, 1)))
    got = temb.grid_sincos_3d((2, 13, 21, 7, 1)).numpy()
    assert got.shape == want.shape == (2, 13, 21, 7, 5) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert temb.EMBEDDINGS["sincos3d"] is temb.grid_sincos_3d


def _flax(module):
    return jax.tree.map(jnp.asarray, bridge.params_to_flax(module))


# The resize-or-conv-first rule: the encoder (downsampling, Ci < Co)
# truncates first and convolves at the small grid, returning the conv's
# dtype; the decoder (upsampling, Ci > Co) convolves first and returns the
# truncation's f32.  The same grid takes the conv-first branch (a tie).
POINTWISE_CASES = [
    (4, 8, (16, 16, 10), (12, 12, 10), "resize_first"),
    (16, 4, (8, 8, 6), (12, 12, 16), "conv_first"),
    (3, 5, (8, 10, 6), (8, 10, 6), "conv_first"),
]


@pytest.mark.parametrize("dtype,bound", [("float32", 1e-5), ("bfloat16", 2**-8)])
@pytest.mark.parametrize("ci,co,grid,out,order", POINTWISE_CASES)
def test_pointwise_op_3d_matches_uno_tpu(ci, co, grid, out, order, dtype, bound, jax_fft):
    x = np.random.default_rng(6).standard_normal((2, ci) + grid).astype(np.float32)
    tdt = getattr(torch, dtype)
    tm = tl.PointwiseOp(ci, co, tdt, generator=torch.Generator().manual_seed(0))
    jm = jl.PointwiseOp(ci, co, 3, dtype=jnp.dtype(dtype))
    xj = jnp.asarray(x, dtype)
    want = jax.jit(jm.apply, static_argnums=2)(_flax(tm), xj, out)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).to(tdt), out)
    out_dtype = tdt if order == "resize_first" else torch.float32
    assert got.dtype == out_dtype and str(want.dtype) == str(out_dtype).split(".")[-1]
    assert got.shape == want.shape == (2, co) + out
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) <= bound


@pytest.mark.parametrize("dtype,bound", [("float32", 1e-5), ("bfloat16", 2**-8)])
@pytest.mark.parametrize("normalize,ci,co,grid,out,modes", [
    (True, 4, 8, (16, 16, 10), (12, 12, 10), (5, 5, 3)),   # encoder: truncation first
    (False, 16, 4, (8, 8, 6), (12, 12, 16), (4, 4, 3)),    # decoder: conv first
])
def test_operator_block_3d_matches_uno_tpu(normalize, ci, co, grid, out, modes, dtype, bound,
                                           jax_fft):
    x = np.random.default_rng(7).standard_normal((2, ci) + grid).astype(np.float32)
    tdt = getattr(torch, dtype)
    tm = tl.OperatorBlock(ci, co, modes, normalize, dtype=tdt,
                          generator=torch.Generator().manual_seed(1))
    assert tm.conv.weights.shape == (4, ci, co) + modes
    if normalize:  # a non-trivial affine
        with torch.no_grad():
            tm.norm_scale.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(2))
            tm.norm_bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(3))
    jm = jl.OperatorBlock(ci, co, modes, normalize=normalize, dtype=jnp.dtype(dtype))
    xj = jnp.asarray(x, dtype)
    want = jax.jit(jm.apply, static_argnums=2)(_flax(tm), xj, out)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).to(tdt), out)
    assert got.dtype == tdt and str(want.dtype) == dtype
    assert got.shape == want.shape == (2, co) + out
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) <= bound


@pytest.mark.parametrize("ci,co,grid,out,order", POINTWISE_CASES[:2])
def test_pointwise_op_3d_on_the_dft_path_matches_uno_tpu(ci, co, grid, out, order, dft_mode):
    """Under bf16 the DFT truncation keeps bf16, so both branch orders end
    in bf16, as in uno_tpu."""
    x = np.random.default_rng(11).standard_normal((2, ci) + grid).astype(np.float32)
    tm = tl.PointwiseOp(ci, co, torch.bfloat16, generator=torch.Generator().manual_seed(0))
    jm = jl.PointwiseOp(ci, co, 3, dtype=jnp.bfloat16)
    want = jax.jit(jm.apply, static_argnums=2)(_flax(tm), jnp.asarray(x, jnp.bfloat16), out)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).bfloat16(), out)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert got.shape == want.shape == (2, co) + out
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) <= DFT_BOUND["bfloat16"]
