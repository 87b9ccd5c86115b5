"""The port's complex mode contraction (uno_tpu_torch/ops/kernels/cmul.py).

On the CPU the wrapper runs its plain version, held against uno_tpu's Pallas
kernel in interpret mode at atol 1e-4 (the bound of tests/test_pallas.py).
The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uno_tpu.ops.pallas.cmul import complex_mode_matmul_pallas
from uno_tpu_torch.ops.kernels import cmul as K

def _rand_c(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("b,ci,co,m", [(2, 3, 5, 7), (4, 8, 8, 128), (2, 4, 6, 200)])
def test_plain_matches_pallas_interpret(b, ci, co, m):
    rng = np.random.default_rng(0)
    x, w = _rand_c(rng, b, ci, m), _rand_c(rng, ci, co, m)
    want = np.asarray(complex_mode_matmul_pallas(jnp.asarray(x), jnp.asarray(w), True))
    before = K.LAUNCHES
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
    with pytest.raises(RuntimeError, match="backward"):
        K.cmul(x, w.requires_grad_())
    with torch.no_grad():
        assert K.cmul(x, w).shape == (2, 4, 8)
