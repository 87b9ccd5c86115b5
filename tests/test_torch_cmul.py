"""The port's complex mode contraction (uno_tpu_torch/ops/kernels/cmul.py).

On the CPU the wrapper runs its plain versions, held against uno_tpu's Pallas
kernel in interpret mode at atol 1e-4 (the bound of tests/test_pallas.py),
forward and backward.  The backward is compared through a real loss
``L = sum(re(conj(c) * y))``: torch's gradient of a complex input is the
conjugate of ``jax.grad``'s, so the JAX gradients are conjugated first.  The
CUDA kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uno_tpu.ops.pallas.cmul import complex_mode_matmul_pallas
from uno_tpu_torch.ops.kernels import cmul as K

SHAPES = [(2, 3, 5, 7), (4, 8, 8, 128), (2, 4, 6, 200)]


def _rand_c(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("b,ci,co,m", SHAPES)
def test_plain_matches_pallas_interpret(b, ci, co, m):
    rng = np.random.default_rng(0)
    x, w = _rand_c(rng, b, ci, m), _rand_c(rng, ci, co, m)
    want = np.asarray(complex_mode_matmul_pallas(jnp.asarray(x), jnp.asarray(w), True))
    before = dict(K.LAUNCHES)
    got = K.cmul(torch.from_numpy(x), torch.from_numpy(w))
    assert K.LAUNCHES == before  # a CPU tensor never reaches the kernel
    assert got.dtype == torch.complex64 and got.shape == (b, co, m)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(2, 3, 8, dtype=torch.complex64)
    w = torch.zeros(3, 4, 8, dtype=torch.complex64)
    with pytest.raises(TypeError):
        K.cmul(x.real.contiguous(), w)
    with pytest.raises(ValueError, match="mismatch"):
        K.cmul(x, w[:2].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        K.cmul(x.transpose(0, 1).contiguous().transpose(0, 1), w)
    with pytest.raises(ValueError):
        K.cmul(x[:0], w)
    with pytest.raises(ValueError, match="mismatch"):
        K.cmul_bwd_x(torch.zeros(2, 5, 8, dtype=torch.complex64), w)
    with pytest.raises(ValueError, match="mismatch"):
        K.cmul_bwd_w(x, torch.zeros(3, 4, 8, dtype=torch.complex64))
    # inputs that require grad train: the gradients flow through the Function
    y = K.cmul(x, w.requires_grad_())
    assert y.requires_grad and y.grad_fn is not None
    y.real.sum().backward()
    assert w.grad is not None and w.grad.shape == w.shape
    with torch.no_grad():
        assert K.cmul(x, w).grad_fn is None


@pytest.mark.parametrize("b,ci,co,m", SHAPES)
def test_gradients_match_pallas_interpret(b, ci, co, m):
    rng = np.random.default_rng(1)
    x, w, c = _rand_c(rng, b, ci, m), _rand_c(rng, ci, co, m), _rand_c(rng, b, co, m)

    def loss(x, w):
        y = complex_mode_matmul_pallas(x, w, True)
        return jnp.sum(jnp.real(jnp.conj(jnp.asarray(c)) * y))

    jgx, jgw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    torch.real(torch.from_numpy(c).conj() * K.cmul(xt, wt)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.conj(np.asarray(jgx)), rtol=0, atol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(), np.conj(np.asarray(jgw)), rtol=0, atol=1e-4)


def test_gradcheck_complex128():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(_rand_c(rng, 2, 3, 5).astype(np.complex128)).requires_grad_()
    w = torch.from_numpy(_rand_c(rng, 3, 4, 5).astype(np.complex128)).requires_grad_()
    assert torch.autograd.gradcheck(K.cmul, (x, w))


def test_backward_computes_only_the_gradients_asked_for():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_rand_c(rng, 2, 3, 5))
    w = torch.from_numpy(_rand_c(rng, 3, 4, 5)).requires_grad_()
    K.cmul(x, w).abs().sum().backward()
    assert x.grad is None and w.grad is not None
