"""The port's fused projection head (uno_tpu_torch/ops/kernels/mlp_head.py).

On the CPU the wrapper runs its plain version, held against uno_tpu's fused
head in interpret mode with the same bf16 x (both sides round the same f32
values to nearest-even).  Bound: rel-L2 <= 1e-5; the one difference in the
math is uno_tpu's polynomial erf (|err| <= 1.5e-7) against the exact erf.

The gradients are held against ``jax.grad`` of uno_tpu's fused head, which
runs its backward kernel in interpret mode, with the fixed cotangent of
tests/test_fused_head.py.  Bounds: rel-L2 <= 1e-5 for the f32 weight
gradients; <= 4e-3 for the bf16 input gradient (one bf16 ulp: the two sides
round f32 values that differ in the last bits).  The CUDA kernels are held
against the plain versions on the card by tests/test_torch_cuda.py.
"""

import jax
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
    before = dict(K.LAUNCHES)
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
    with pytest.raises(ValueError, match="flat"):
        K.mlp_head_bwd(xb, torch.zeros(1, 1, 5, 6), k1, b1, k2)
    with pytest.raises(ValueError, match="f32 g"):
        K.mlp_head_bwd(xb.reshape(1, 4, 30), torch.zeros(1, 1, 30).double(), k1, b1, k2)
    # inputs that require grad train: the gradients flow through the Function
    out = K.mlp_head(xb, k1.requires_grad_(), b1, k2, b2)
    assert out.grad_fn is not None
    out.sum().backward()
    assert k1.grad is not None and k1.grad.shape == k1.shape
    with torch.no_grad():
        assert K.mlp_head(xb, k1, b1, k2, b2).grad_fn is None


@pytest.mark.parametrize("shape,h,o", SHAPES)
def test_gradients_match_fused_head_interpret(shape, h, o):
    x, *w = _inputs(shape, h, o, seed=1)
    cot = np.random.default_rng(2).standard_normal((shape[0], o) + shape[2:]).astype(np.float32)

    def loss(*a):
        return jnp.sum(fused_mlp_head(*a, True) * jnp.asarray(cot))

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, w))
    args = [torch.from_numpy(x).bfloat16()] + [torch.from_numpy(a) for a in w]
    for a in args:
        a.requires_grad_()
    (K.mlp_head(*args) * torch.from_numpy(cot)).sum().backward()
    assert args[0].grad.dtype == torch.bfloat16 and want[0].dtype == jnp.bfloat16
    for name, a, wj in zip(["gx", "gk1", "gb1", "gk2", "gb2"], args, want):
        bound = 4e-3 if name == "gx" else 1e-5
        assert a.grad.shape == wj.shape, name
        assert _rel(a.grad.float().numpy(), np.asarray(wj, np.float32)) <= bound, name


@pytest.mark.parametrize("shape,h,o", SHAPES)
def test_plain_backward_matches_autograd_of_plain_forward(shape, h, o):
    x, *w = _inputs(shape, h, o, seed=3)
    b, c = shape[:2]
    xb = torch.from_numpy(x).bfloat16().reshape(b, c, -1)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal((b, o, xb.shape[2]))
                         .astype(np.float32))
    got = K.mlp_head_bwd_plain(xb, g, *map(torch.from_numpy, w[:3]))
    args = [xb.clone().requires_grad_()] + [torch.from_numpy(a).requires_grad_() for a in w]
    (K.mlp_head_plain(*args) * g).sum().backward()
    assert got[0].dtype == torch.bfloat16
    for gp, a in zip(got, args):
        assert _rel(gp.float().numpy(), a.grad.float().numpy()) <= (4e-3 if gp is got[0] else 1e-5)
