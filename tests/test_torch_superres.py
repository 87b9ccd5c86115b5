"""The port's ``evaluate_superres`` against uno_tpu's: the same weights
evaluated at the training grid and at a finer grid (U-NO's
discretisation-invariance contract).

uno9 at width 8 with pad 1, the port's init carried to flax by
uno_tpu_torch.bridge; fields at 169x169 and their ``::2`` subsample at
85x85, as tests/test_superres.py makes them.  Bounds: each rel-L2 within
rel 1e-4 of uno_tpu's at f32 (the model bound of tests/test_torch_model.py:
FFT and summation orders differ), and within rel 2e-2 under the bf16 policy
with the fused head on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uno_tpu.models import build_model as jax_build_model
from uno_tpu.ops.pallas.mlp_head import set_fused_head_mode
from uno_tpu.train.evaluate import evaluate_superres as j_evaluate_superres
from uno_tpu_torch import bridge
from uno_tpu_torch.models import build_model
from uno_tpu_torch.train.evaluate import evaluate_darcy, evaluate_superres

KW = dict(in_width=3, width=8, pad=1)


def _fields(n=3, s=169, seed=0):
    """A 3/12 coefficient field and a smooth target at s x s, and both
    subsampled ::2."""
    rng = np.random.default_rng(seed)
    a = np.where(rng.standard_normal((n, s, s, 1)) > 0, 12.0, 3.0).astype(np.float32)
    u = (rng.standard_normal((n, s, s)).cumsum(1).cumsum(2) / s**2).astype(np.float32)
    return a[:, ::2, ::2], u[:, ::2, ::2], a, u


@pytest.mark.parametrize("dtype,bound", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_evaluate_superres_matches_uno_tpu(dtype, bound):
    x_lo, y_lo, x_hi, y_hi = _fields()
    assert x_lo.shape[1:3] == (85, 85) and x_hi.shape[1:3] == (169, 169)
    model = build_model("uno9", dtype=dtype, generator=torch.Generator().manual_seed(0), **KW)
    model.eval()
    tree = jax.tree.map(jnp.asarray, bridge.params_to_flax(model))
    set_fused_head_mode(dtype == "bfloat16")
    try:
        want = j_evaluate_superres(jax_build_model("uno9", dtype=dtype, **KW), tree,
                                   x_lo, y_lo, x_hi, y_hi, batch_size=2)
    finally:
        set_fused_head_mode(None)
    got = evaluate_superres(model, x_lo, y_lo, x_hi, y_hi, batch_size=2)
    assert set(got) == set(want) == {"rel_l2_train_res", "rel_l2_super_res"}
    for k in got:
        assert np.isfinite(got[k]) and got[k] == pytest.approx(want[k], rel=bound), (
            k, got[k], want[k])
    # each number is evaluate_darcy at its grid
    assert got["rel_l2_train_res"] == evaluate_darcy(model, x_lo, y_lo, 2)
    assert got["rel_l2_super_res"] == evaluate_darcy(model, x_hi, y_hi, 2)
