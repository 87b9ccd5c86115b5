"""uno9 on the partial-DFT path: the port against uno_tpu, both with the DFT
path forced on, forward and gradients.

The helpers and bounds are those of tests/test_torch_model.py (forward:
rel-L2 <= 1e-4 at f32, <= 2e-2 under bf16 at seed 1, and the bf16 drift
ratio at seeds 0 and 2) and tests/test_torch_train.py (gradients: rel-L2
<= 1e-4 per leaf at f32; under bf16 each leaf no further from uno_tpu's f32
gradient than 2x uno_tpu's own bf16 error + 0.02).  On this path a bf16
block's spectral conv returns bf16 and ``k + w`` is summed in bf16 in both
packages (uno_tpu/nn/layers.py OperatorBlock).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests import test_torch_model as M
from tests import test_torch_train as T
from uno_tpu.models import build_model as jax_build_model
from uno_tpu.ops import spectral as jspec
from uno_tpu_torch.ops.spectral import set_dft_mode


@pytest.fixture(autouse=True)
def dft_mode():
    jspec.set_dft_mode(True)
    set_dft_mode(True)
    yield
    jspec.set_dft_mode(None)
    set_dft_mode(None)


@pytest.mark.parametrize("dtype,seed,bound", [("float32", 0, 1e-4), ("bfloat16", 1, 2e-2)])
def test_uno9_dft_forward_matches_uno_tpu(dtype, seed, bound):
    got, want, _, _ = M._both(dtype, seed)
    assert got.shape == want.shape == (2, 85, 85, 1) and got.dtype == np.float32
    assert M._rel(got, want) <= bound, M._rel(got, want)


@pytest.mark.parametrize("seed", [0, 2])
def test_uno9_dft_bf16_drift_is_no_worse_than_uno_tpus(seed):
    got, want, tree, x = M._both("bfloat16", seed)
    f32 = np.asarray(jax.jit(jax_build_model("uno9", **M.KW).apply)(tree, jnp.asarray(x)))
    assert M._rel(got, f32) <= 2 * M._rel(want, f32), (M._rel(got, f32), M._rel(want, f32))


def test_uno9_dft_loss_and_gradients_match_uno_tpu_f32():
    tl, tg, jl, jg, _ = T._grads_both("float32", fused=False)
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    assert set(tg) == set(jg)
    total = np.sqrt(sum(np.linalg.norm(g) ** 2 for g in jg.values()))
    normed = {i for i, b in enumerate(jax_build_model("uno9", **T.KW).spec.blocks)
              if b.normalize}
    for path, g in tg.items():
        want = np.conj(jg[path])
        assert g.shape == want.shape, path
        if path[1:] == ("w", "bias") and int(path[0][len("block"):]) in normed:
            assert max(np.linalg.norm(g), np.linalg.norm(want)) <= 1e-6 * total, path
        else:
            assert T._rel(g, want) <= 1e-4, (path, T._rel(g, want))


def test_uno9_dft_bf16_gradients_are_as_accurate_as_uno_tpus():
    _, tg, _, jg, tree = T._grads_both("bfloat16", fused=True, seed=1)
    x, y = T._darcy_data(2, 85, 1)
    j32 = jax_build_model("uno9", **T.KW)

    def loss32(p):
        out = j32.apply(p, jnp.asarray(x)).reshape(2, 85, 85)
        return T.j_relative_lp_loss(out, jnp.asarray(y), reduction="sum")

    g32 = T._flat_tree(jax.jit(jax.grad(loss32))(tree))
    for path, g in tg.items():
        assert np.isfinite(g).all(), path
        truth = np.conj(g32[path])
        err_port = T._rel(g, truth)
        err_jax = T._rel(np.conj(np.asarray(jg[path], np.complex128)), truth)
        assert err_port <= 2.0 * err_jax + 0.02, (path, err_port, err_jax)
