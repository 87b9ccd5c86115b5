"""The port's fused projection head (uno_tpu_torch/ops/kernels/mlp_head.py).

On the CPU the wrapper runs its plain version, held against uno_tpu's fused
head in interpret mode with the same bf16 x (both sides round the same f32
values to nearest-even).  Bound: rel-L2 <= 1e-5; the one difference in the
math is uno_tpu's polynomial erf (|err| <= 1.5e-7) against the exact erf.
The CUDA kernel is held against the plain version on the card by
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uno_tpu.ops.pallas.mlp_head import fused_mlp_head
from uno_tpu_torch.ops.kernels import mlp_head as K

SHAPES = [
    ((2, 8, 37, 45), 32, 1),   # uneven grid: a masked tail
    ((1, 16, 64, 64), 64, 3),  # several outputs, H > the kernel's 32-unit pass
]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _inputs(shape, h, o, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[1]
    x = rng.standard_normal(shape).astype(np.float32)
    k1 = (rng.standard_normal((c, h)) / np.sqrt(c)).astype(np.float32)
    b1 = rng.standard_normal(h).astype(np.float32)
    k2 = (rng.standard_normal((h, o)) / np.sqrt(h)).astype(np.float32)
    b2 = rng.standard_normal(o).astype(np.float32)
    return x, k1, b1, k2, b2


@pytest.mark.parametrize("shape,h,o", SHAPES)
def test_plain_matches_fused_head_interpret(shape, h, o):
    x, *w = _inputs(shape, h, o)
    want = np.asarray(fused_mlp_head(jnp.asarray(x, jnp.bfloat16),
                                     *map(jnp.asarray, w), True))
    before = K.LAUNCHES
    got = K.mlp_head(torch.from_numpy(x).bfloat16(), *map(torch.from_numpy, w))
    assert K.LAUNCHES == before
    assert got.dtype == torch.float32 and got.shape == want.shape == (shape[0], o) + shape[2:]
    assert _rel(got.numpy(), want) <= 1e-5, _rel(got.numpy(), want)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, k1, b1, k2, b2 = map(torch.from_numpy, _inputs((1, 4, 5, 6), 8, 1))
    xb = x.bfloat16()
    with pytest.raises(TypeError, match="bf16"):
        K.mlp_head(x, k1, b1, k2, b2)
    with pytest.raises(TypeError, match="f32"):
        K.mlp_head(xb, k1.double(), b1, k2, b2)
    with pytest.raises(ValueError, match="shapes"):
        K.mlp_head(xb, k1[:3].contiguous(), b1, k2, b2)
    with pytest.raises(ValueError, match="contiguous"):
        K.mlp_head(xb.transpose(2, 3), k1, b1, k2, b2)
    with pytest.raises(ValueError, match="outputs"):
        K.mlp_head(xb, k1, b1, torch.zeros(8, 5), torch.zeros(5))
    with pytest.raises(ValueError, match="shared memory"):
        K.mlp_head(torch.zeros(1, 512, 4, dtype=torch.bfloat16),
                   torch.zeros(512, 32), torch.zeros(32), torch.zeros(32, 1), b2)
    with pytest.raises(RuntimeError, match="backward"):
        K.mlp_head(xb, k1.requires_grad_(), b1, k2, b2)
