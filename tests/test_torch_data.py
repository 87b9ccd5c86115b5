"""The port's Darcy data generator against uno_tpu's, on the CPU at s <= 33.

* ``darcy_grf_from_xi`` fed the ``xi`` that ``jax.random.normal(key,
  (n, s, s))`` gives equals ``uno_tpu``'s ``darcy_grf(key, ...)``: rel-L2
  <= 1e-5 (f32 einsums in different orders);
* the stencil operator on the same (a, p): rel-L2 <= 1e-6;
* ``solve_darcy`` on the same coefficients: rel-L2 <= 1e-4.  Both run CG in
  f32 to maxiter (f32 cannot reach tol 1e-8), so solutions are compared, not
  iteration counts; at a reachable tol and at a small maxiter the same
  stopping rule and the batch-as-one-system rule give the same iterate:
  rel-L2 <= 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uno_tpu.data import darcy_solver as jsolver
from uno_tpu.data import grf as jgrf
from uno_tpu_torch.data import darcy_solver as solver
from uno_tpu_torch.data import grf


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@pytest.mark.parametrize("n,s,alpha,tau", [(3, 33, 2.0, 3.0), (2, 16, 2.5, 7.0)])
def test_darcy_grf_from_jax_xi_matches_uno_tpu(n, s, alpha, tau):
    key = jax.random.PRNGKey(7)
    xi = np.array(jax.random.normal(key, (n, s, s)))
    want = np.asarray(jgrf.darcy_grf(key, n, s, alpha, tau))
    got = grf.darcy_grf_from_xi(torch.from_numpy(xi), alpha, tau)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) <= 1e-5, _rel(got.numpy(), want)


def test_darcy_grf_draws_from_the_generator():
    a = grf.darcy_grf(torch.Generator().manual_seed(3), 2, 17)
    b = grf.darcy_grf(torch.Generator().manual_seed(3), 2, 17)
    c = grf.darcy_grf(torch.Generator().manual_seed(4), 2, 17)
    assert a.shape == (2, 17, 17) and torch.equal(a, b) and not torch.equal(a, c)


def _coefficients(n, s, seed=0, mode="threshold"):
    g = np.asarray(jgrf.darcy_grf(jax.random.PRNGKey(seed), n, s))
    return np.where(g >= 0, 12.0, 4.0).astype(np.float32) if mode == "threshold" \
        else np.exp(g).astype(np.float32)


def test_apply_operator_matches_uno_tpu():
    a = _coefficients(2, 17)
    p = np.random.default_rng(0).standard_normal((2, 17, 17)).astype(np.float32)
    want = np.asarray(jsolver._apply_operator(jnp.asarray(a), jnp.asarray(p), 256.0))
    got = solver._apply_operator(torch.from_numpy(a), torch.from_numpy(p), 256.0)
    assert _rel(got.numpy(), want) <= 1e-6
    assert torch.all(got[:, 0] == 0) and torch.all(got[:, :, -1] == 0)


@pytest.mark.parametrize("mode", ["threshold", "lognormal"])
@pytest.mark.parametrize("s", [17, 33])
def test_solve_darcy_matches_uno_tpu(s, mode):
    a = _coefficients(2, s, seed=s, mode=mode)
    f = np.ones_like(a)
    want = np.asarray(jsolver.solve_darcy(jnp.asarray(a), jnp.asarray(f)))
    info = {}
    got = solver.solve_darcy(torch.from_numpy(a), torch.from_numpy(f), info=info)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) <= 1e-4, _rel(got.numpy(), want)
    assert 0 < info["iterations"] <= 2000 and info["residual"] < 1e-5
    # it solves the system: the true residual is small too
    res = f - solver._apply_operator(torch.from_numpy(a), got, float((s - 1) ** 2)).numpy()
    assert np.linalg.norm(res[:, 1:-1, 1:-1]) <= 1e-3 * np.linalg.norm(f[:, 1:-1, 1:-1])


@pytest.mark.parametrize("tol,maxiter", [(1e-3, 2000), (1e-8, 7)])
def test_cg_stops_where_jaxs_cg_stops(tol, maxiter):
    """A reachable tol, and a maxiter that cuts the run: the port's iterate
    is uno_tpu's.  A step more or less, or one CG per sample instead of one
    per batch, moves the iterate by far more than the bound."""
    a = _coefficients(3, 33, seed=5)
    f = np.ones_like(a)
    want = np.asarray(jsolver.solve_darcy(jnp.asarray(a), jnp.asarray(f), tol=tol,
                                          maxiter=maxiter))
    info = {}
    got = solver.solve_darcy(torch.from_numpy(a), torch.from_numpy(f), tol=tol,
                             maxiter=maxiter, info=info)
    assert _rel(got.numpy(), want) <= 1e-5, _rel(got.numpy(), want)
    if maxiter == 7:
        assert info["iterations"] == 7
        alone = solver.solve_darcy(torch.from_numpy(a[:1]), torch.from_numpy(f[:1]),
                                   tol=tol, maxiter=maxiter)
        assert _rel(got[:1].numpy(), alone.numpy()) > 1e-3
    else:
        assert info["iterations"] < 2000 and info["residual"] <= tol


def test_generate_darcy_batch():
    info = {}
    a, p = solver.generate_darcy_batch(torch.Generator().manual_seed(0), 3, 17, info=info)
    assert a.shape == p.shape == (3, 17, 17) and a.dtype == p.dtype == torch.float32
    assert set(a.unique().tolist()) == {4.0, 12.0}
    assert torch.all(p[:, 0] == 0) and torch.all(p[:, :, 0] == 0) and torch.all(p >= 0)
    assert info["iterations"] > 0
    a2, p2 = solver.generate_darcy_batch(torch.Generator().manual_seed(0), 3, 17)
    assert torch.equal(a, a2) and torch.equal(p, p2)
    a3, _ = solver.generate_darcy_batch(torch.Generator().manual_seed(0), 3, 17,
                                        coef_mode="lognormal")
    assert torch.all(a3 > 0) and len(a3.unique()) > 2
    with pytest.raises(ValueError):
        solver.generate_darcy_batch(torch.Generator(), 1, 9, coef_mode="other")
