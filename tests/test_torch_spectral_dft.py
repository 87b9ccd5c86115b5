"""The port's partial-DFT 2-D spectral conv against uno_tpu's, and against
the port's own FFT path.

uno_tpu runs ``spectral_conv_2d`` under ``set_dft_mode(True)``; the port under
its own ``set_dft_mode(True)``.  Bounds, on the shapes of
tests/test_torch_spectral.py (including the overlapping-corner case):
* f32: rel-L2 <= 1e-5 for the output and for the gradients of a real loss
  with respect to x and the weights (``jax.grad``'s weight gradient
  conjugated: torch's is its conjugate);
* bf16: the output and x's gradient are bf16 after five bf16 roundings in
  each package, at different points of different libraries: rel-L2 <= 2e-2,
  the bf16 bound of tests/test_torch_model.py; the weight gradient is
  summed in f32 from bf16 operands: rel-L2 <= 2e-2;
* the port's DFT path against its FFT path at f32: rel-L2 <= 1e-5;
* a complex128 ``gradcheck`` of the hand-written backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_spectral import CASES, _inputs, _rel
from uno_tpu.ops import spectral as jspec
from uno_tpu_torch.ops import spectral as tspec
from uno_tpu_torch.ops.spectral import set_dft_mode, spectral_conv_2d

BOUND = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture
def dft_mode():
    jspec.set_dft_mode(True)
    set_dft_mode(True)
    yield
    jspec.set_dft_mode(None)
    set_dft_mode(None)


def _cast(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,out_size,modes", CASES)
def test_dft_conv_matches_uno_tpu(dft_mode, shape, out_size, modes, dtype):
    x, wt = _inputs(shape, modes)
    want = jspec.spectral_conv_2d(jnp.asarray(x, dtype), jnp.asarray(wt), out_size, modes)
    got = spectral_conv_2d(_cast(x, dtype), torch.from_numpy(wt), out_size, modes)
    assert str(got.dtype) == f"torch.{dtype}" and want.dtype == jnp.dtype(dtype)
    assert tuple(got.shape) == want.shape
    rel = _rel(got.float().numpy(), np.asarray(want, np.float32))
    assert rel <= BOUND[dtype], rel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,out_size,modes", CASES[:3])
def test_dft_conv_gradients_match_uno_tpu(dft_mode, shape, out_size, modes, dtype):
    x, wt = _inputs(shape, modes, seed=1)
    cot = np.random.default_rng(2).standard_normal((shape[0], shape[2]) + out_size)
    cot = cot.astype(np.float32)

    def loss(x, wt):
        y = jspec.spectral_conv_2d(x, wt, out_size, modes)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(cot))

    jgx, jgw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x, dtype), jnp.asarray(wt))
    xt = _cast(x, dtype).requires_grad_()
    wtt = torch.from_numpy(wt).requires_grad_()
    y = spectral_conv_2d(xt, wtt, out_size, modes)
    (y.float() * torch.from_numpy(cot)).sum().backward()
    assert xt.grad.dtype == xt.dtype and wtt.grad.dtype == torch.complex64
    rx = _rel(xt.grad.float().numpy(), np.asarray(jgx, np.float32))
    rw = _rel(wtt.grad.numpy(), np.conj(np.asarray(jgw)))
    assert rx <= BOUND[dtype] and rw <= BOUND[dtype], (rx, rw)
    if 2 * modes[0] > out_size[0]:
        # the positive-kx rows the negative-kx block overwrites get no gradient
        n_top = out_size[0] - modes[0]
        assert torch.all(wtt.grad[0, :, :, n_top:] == 0)
        assert torch.any(wtt.grad[0, :, :, :n_top] != 0)


@pytest.mark.parametrize("shape,out_size,modes", CASES[:3])
def test_dft_path_matches_the_fft_path(shape, out_size, modes):
    x, wt = _inputs(shape, modes, seed=3)
    cot = torch.from_numpy(
        np.random.default_rng(4).standard_normal((shape[0], shape[2]) + out_size)
        .astype(np.float32))
    results = []
    for mode in (False, True):
        set_dft_mode(mode)
        try:
            xt = torch.from_numpy(x).requires_grad_()
            wtt = torch.from_numpy(wt).requires_grad_()
            y = spectral_conv_2d(xt, wtt, out_size, modes)
            (y * cot).sum().backward()
        finally:
            set_dft_mode(None)
        results.append((y.detach(), xt.grad, wtt.grad))
    for got, want in zip(results[1], results[0]):
        assert _rel(got.numpy(), want.numpy()) <= 1e-5, _rel(got.numpy(), want.numpy())


@pytest.mark.parametrize("hw,out_size,modes", [
    ((8, 8), (6, 6), (3, 2)),     # downsample
    ((6, 7), (10, 9), (2, 3)),    # upsample, odd sizes
    ((8, 8), (5, 6), (3, 2)),     # 2*m1 > d1: corners overlap
])
def test_dft_conv_gradcheck_complex128(dft_mode, hw, out_size, modes):
    """torch's complex convention for the weight's gradient: gradcheck
    differentiates the real and imaginary parts separately, so a conjugated
    (JAX-convention) gradient fails it."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn((1, 2) + hw, generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn((2, 2, 3) + modes, generator=g, dtype=torch.complex128, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x, w: spectral_conv_2d(x, w, out_size, modes), (x, w))


def test_the_environment_variable_turns_the_dft_path_on(monkeypatch):
    x, wt = _inputs((2, 4, 6, 32, 32), (5, 4))
    xb, w = torch.from_numpy(x).bfloat16(), torch.from_numpy(wt)
    monkeypatch.delenv("UNO_TPU_TORCH_DFT", raising=False)
    assert spectral_conv_2d(xb, w, (16, 16), (5, 4)).dtype == torch.float32  # FFT
    monkeypatch.setenv("UNO_TPU_TORCH_DFT", "1")
    assert tspec._dft_enabled()
    assert spectral_conv_2d(xb, w, (16, 16), (5, 4)).dtype == torch.bfloat16  # DFT
    set_dft_mode(False)  # the setter overrides the environment
    try:
        assert not tspec._dft_enabled()
    finally:
        set_dft_mode(None)


@pytest.mark.parametrize("m,d", [(5, 16), (6, 10), (4, 8), (7, 7)])
def test_kept_rows_equal_the_fft_paths(m, d):
    """``_slice_pm`` keeps the rows the FFT path writes into the output
    spectrum (``n_top`` positive rows, then all m negative ones), and
    ``_unslice_pm`` is its transpose."""
    n_top, idx = tspec._keep_idx(m, d)
    assert n_top == min(m, d - m) and len(idx) == n_top + m
    out = torch.arange(2 * m, dtype=torch.float32).reshape(1, 1, 1, 2 * m, 1)
    kept = tspec._slice_pm(out, -2, m, n_top)
    assert kept.flatten().tolist() == list(range(n_top)) + list(range(m, 2 * m))
    g = torch.randn(kept.shape, dtype=torch.float64)
    back = tspec._unslice_pm(g, -2, m, n_top)
    assert back.shape == out.shape
    assert float((kept.double() * g).sum()) == pytest.approx(float((out.double() * back).sum()))
