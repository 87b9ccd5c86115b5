"""The port's FFT-path 2-D spectral conv against uno_tpu's.

uno_tpu runs its FFT path (the default off the TPU) with its XLA contraction
and with its Pallas contraction kernel in interpret mode.  Bound: rel-L2 <=
1e-5 at f32 (the two FFT libraries sum in different orders), for the output
and for the gradients of a real loss with respect to x and the weights
(``jax.grad``'s weight gradient conjugated: torch's is its conjugate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uno_tpu.ops import spectral as jspec
from uno_tpu_torch.ops.spectral import spectral_conv_2d, spectral_weight_init

CASES = [
    # (B, Ci, Co, H, W), out_size, modes
    ((2, 4, 6, 32, 32), (16, 16), (5, 4)),    # downsample
    ((2, 4, 3, 16, 20), (33, 40), (6, 5)),    # upsample, odd output
    ((2, 3, 5, 16, 16), (10, 10), (6, 5)),    # 2*m1 > d1: corners overlap
    ((1, 8, 8, 85, 85), (85, 85), (18, 18)),  # same grid, the last uno9 block's modes
]


def _rel(a, b):
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _inputs(shape, modes, seed=0):
    b, ci, co, h, w = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, ci, h, w)).astype(np.float32)
    wshape = (2, ci, co) + tuple(modes)
    wt = (rng.standard_normal(wshape) + 1j * rng.standard_normal(wshape)).astype(np.complex64)
    return x, wt


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("shape,out_size,modes", CASES)
def test_spectral_conv_2d_matches_uno_tpu(shape, out_size, modes, pallas):
    x, wt = _inputs(shape, modes)
    jspec.set_dft_mode(False)
    jspec.set_pallas_mode(pallas, interpret=True)
    try:
        want = np.asarray(
            jspec.spectral_conv_2d(jnp.asarray(x), jnp.asarray(wt), out_size, modes)
        )
    finally:
        jspec.set_dft_mode(None)
        jspec.set_pallas_mode(None)
    got = spectral_conv_2d(torch.from_numpy(x), torch.from_numpy(wt), out_size, modes)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got.numpy(), want) <= 1e-5, _rel(got.numpy(), want)


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("shape,out_size,modes", CASES[:3])
def test_spectral_conv_2d_gradients_match_uno_tpu(shape, out_size, modes, pallas):
    x, wt = _inputs(shape, modes, seed=1)
    cot = np.random.default_rng(2).standard_normal((shape[0], shape[2]) + out_size)
    cot = cot.astype(np.float32)

    def loss(x, wt):
        return jnp.sum(jspec.spectral_conv_2d(x, wt, out_size, modes) * jnp.asarray(cot))

    jspec.set_dft_mode(False)
    jspec.set_pallas_mode(pallas, interpret=True)
    try:
        jgx, jgw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(wt))
    finally:
        jspec.set_dft_mode(None)
        jspec.set_pallas_mode(None)
    xt = torch.from_numpy(x).requires_grad_()
    wtt = torch.from_numpy(wt).requires_grad_()
    (spectral_conv_2d(xt, wtt, out_size, modes) * torch.from_numpy(cot)).sum().backward()
    assert _rel(xt.grad.numpy(), jgx) <= 1e-5, _rel(xt.grad.numpy(), jgx)
    assert _rel(wtt.grad.numpy(), np.conj(np.asarray(jgw))) <= 1e-5
    if 2 * modes[0] > out_size[0]:
        # the positive-kx rows the negative-kx block overwrites get no gradient
        n_top = out_size[0] - modes[0]
        assert torch.all(wtt.grad[0, :, :, n_top:] == 0)
        assert torch.any(wtt.grad[0, :, :, :n_top] != 0)


def test_bf16_input_runs_the_transform_in_f32():
    x, wt = _inputs((2, 4, 6, 32, 32), (5, 4))
    xb = torch.from_numpy(x).bfloat16()
    got = spectral_conv_2d(xb, torch.from_numpy(wt), (16, 16), (5, 4))
    want = spectral_conv_2d(xb.float(), torch.from_numpy(wt), (16, 16), (5, 4))
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


def test_modes_beyond_the_grid_raise():
    x, wt = _inputs((1, 2, 2, 8, 8), (9, 3))
    with pytest.raises(ValueError, match="modes"):
        spectral_conv_2d(torch.from_numpy(x), torch.from_numpy(wt), (16, 16), (9, 3))


def test_weight_init_distribution():
    g = torch.Generator().manual_seed(0)
    w = spectral_weight_init(16, 8, (20, 20), 2, g)
    assert w.shape == (2, 16, 8, 20, 20) and w.dtype == torch.complex64
    var = 1.0 / (2.0 * 16) / 2  # scale^2 * 1/2 for each of re and im
    for part in (w.real, w.imag):
        assert abs(part.var().item() - var) < 0.05 * var
        assert abs(part.mean().item()) < 0.05 * var ** 0.5
