"""The port's layers against uno_tpu's flax layers with the same parameters.

Bound: rel-L2 <= 1e-5 at f32 (summation order differs between the
libraries); the resample tables are bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uno_tpu.models import embeddings as jemb
from uno_tpu.nn import layers as jl
from uno_tpu.ops.norm import instance_norm as j_instance_norm
from uno_tpu.ops.resample import resize as j_resize
from uno_tpu.ops.resample import resize_matrix as j_resize_matrix
from uno_tpu_torch.models import embeddings as temb
from uno_tpu_torch.nn import layers as tl
from uno_tpu_torch.ops.norm import instance_norm
from uno_tpu_torch.ops.resample import resize, resize_matrix

# the bicubic-antialias resamples of uno9 at darcy_s211 (padded grid 247)
# and at the 85-grid of the CPU tests
SLICE_SIZES = [(247, 123), (123, 61), (61, 123), (123, 247),
               (86, 43), (43, 21), (21, 43), (43, 86)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("n_in,n_out", SLICE_SIZES)
def test_resize_matrix_is_bit_equal(n_in, n_out):
    got = resize_matrix(n_in, n_out, "cubic", True, True)
    want = j_resize_matrix(n_in, n_out, "cubic", True, True)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("out", [(43, 21), (172, 90), (86, 86)])
def test_resize_matches_uno_tpu(out):
    x = _x((2, 3, 86, 43))
    want = np.asarray(j_resize(jnp.asarray(x), out, (2, 3), "cubic", True, True))
    got = resize(torch.from_numpy(x), out, (2, 3), "cubic", True, True).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-5


def test_instance_norm_matches_uno_tpu():
    x = _x((2, 5, 17, 19)) * 3 + 1
    scale, bias = _x((5,), 1), _x((5,), 2)
    want = np.asarray(j_instance_norm(*map(jnp.asarray, (x, scale, bias))))
    got = instance_norm(*map(torch.from_numpy, (x, scale, bias)))
    assert _rel(got.numpy(), want) <= 1e-5
    gb = instance_norm(torch.from_numpy(x).bfloat16(), *map(torch.from_numpy, (scale, bias)))
    assert gb.dtype == torch.bfloat16


def test_dense_and_gelu_match_uno_tpu():
    x = _x((2, 7, 5, 3))
    jd = jl.Dense(6)
    p = jd.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jl.gelu(jd.apply(p, jnp.asarray(x))))
    td = tl.Dense(3, 6)
    with torch.no_grad():
        td.weight.copy_(torch.tensor(np.asarray(p["params"]["kernel"]).T))
        td.bias.copy_(torch.tensor(np.asarray(p["params"]["bias"])))
        got = tl.gelu(td(torch.from_numpy(x))).numpy()
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("fn", ["grid_linear_2d", "grid_sincos_2d"])
def test_embeddings_match_uno_tpu(fn):
    want = np.asarray(getattr(jemb, fn)((2, 13, 21, 1)))
    got = getattr(temb, fn)((2, 13, 21, 1)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _load(module, params):
    """Copy flax params of a PointwiseOp/OperatorBlock into the port's."""
    from uno_tpu_torch.bridge import params_from_flax

    return params_from_flax(module, jax.tree.map(np.asarray, params))


# encoder blocks resize first (downsampling), decoder blocks conv first.
# Under bf16 the order decides where the rounding happens; both packages
# round at the same points, so they agree to within a bf16 rounding (2**-8).
@pytest.mark.parametrize("dtype,bound", [("float32", 1e-5), ("bfloat16", 2**-8)])
@pytest.mark.parametrize("ci,co,grid,out", [
    (8, 16, (86, 86), (43, 43)),   # encoder order
    (32, 8, (43, 43), (86, 86)),   # decoder order
    (4, 6, (30, 40), (30, 40)),    # no resample
])
def test_pointwise_op_matches_uno_tpu(ci, co, grid, out, dtype, bound):
    x = _x((2, ci) + grid)
    jm = jl.PointwiseOp(ci, co, 2, dtype=jnp.dtype(dtype))
    xj = jnp.asarray(x, dtype)
    p = jm.init(jax.random.PRNGKey(0), xj, out)
    want = np.asarray(jm.apply(p, xj, out).astype(jnp.float32))
    tm = _load(tl.PointwiseOp(ci, co, getattr(torch, dtype)), p)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).to(getattr(torch, dtype)), out)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == want.shape == (2, co) + out
    assert _rel(got.float().numpy(), want) <= bound


@pytest.mark.parametrize("normalize,residual,ci,co,grid,out,modes", [
    (True, False, 8, 16, (43, 43), (21, 21), (8, 8)),
    (False, False, 16, 8, (43, 43), (86, 86), (18, 18)),
    (True, True, 6, 6, (20, 20), (20, 20), (4, 4)),
])
def test_operator_block_matches_uno_tpu(normalize, residual, ci, co, grid, out, modes):
    x = _x((2, ci) + grid)
    jm = jl.OperatorBlock(ci, co, modes, normalize=normalize, residual=residual)
    p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), out)
    if normalize:  # non-trivial affine
        p["params"]["norm_scale"] = jnp.asarray(_x((co,), 1))
        p["params"]["norm_bias"] = jnp.asarray(_x((co,), 2))
    want = np.asarray(jm.apply(p, jnp.asarray(x), out))
    tm = _load(tl.OperatorBlock(ci, co, modes, normalize, residual), p)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), out).numpy()
    assert got.shape == want.shape == (2, co) + out
    assert _rel(got, want) <= 1e-5, _rel(got, want)
