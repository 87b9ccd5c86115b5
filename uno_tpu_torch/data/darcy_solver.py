"""Darcy flow finite-difference solver (port of ``uno_tpu/data/darcy_solver.py``).

Solves ``-div(a grad p) = f`` on [0,1]^2 with p = 0 on the boundary: the
five-point stencil with edge-averaged coefficients of the reference's
``solve_gwf.m``, solved matrix-free by conjugate gradients on the stencil.

CG follows ``jax.scipy.sparse.linalg.cg`` step for step, in f32: x0 = 0,
stop when ``|r|^2 <= max(tol^2 |b|^2, 0)`` (the recursive residual) or after
``maxiter`` steps, and every inner product, alpha and beta is taken over the
whole batched array, so a batch is ONE CG system, not one per sample.  In
f32 the residual does not reach tol = 1e-8 at the reference's grids, so the
solver usually runs to ``maxiter``.  The loop never waits for the device
between steps: each step is masked by the stopping rule on the device, and
the host reads the rule every ``_CHECK_EVERY`` steps to stop early.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from uno_tpu_torch.data.grf import darcy_grf

_CHECK_EVERY = 64  # CG steps between the host's reads of the stopping rule


def _edges(a: torch.Tensor) -> tuple:
    """The edge-averaged coefficients toward the north, south, west and east
    neighbours of each interior node: a constant of the solve."""
    ac = a[..., 1:-1, 1:-1]
    return tuple(0.5 * (ac + nb) for nb in (a[..., :-2, 1:-1], a[..., 2:, 1:-1],
                                             a[..., 1:-1, :-2], a[..., 1:-1, 2:]))


def _apply_edges(edges: tuple, p: torch.Tensor, h2inv: float) -> torch.Tensor:
    en, es, ew, ee = edges
    pc = p[..., 1:-1, 1:-1]
    flux = (
        en * (pc - p[..., :-2, 1:-1])
        + es * (pc - p[..., 2:, 1:-1])
        + ew * (pc - p[..., 1:-1, :-2])
        + ee * (pc - p[..., 1:-1, 2:])
    ) * h2inv
    return F.pad(flux, (1, 1, 1, 1))


def _apply_operator(a: torch.Tensor, p: torch.Tensor, h2inv: float) -> torch.Tensor:
    """(-div(a grad p)) on the interior, p has zero boundary built in.

    a, p: (..., K, K) node values; returns the same shape (boundary zeroed).
    """
    return _apply_edges(_edges(a), p, h2inv)


def _vdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.dot(x.reshape(-1), y.reshape(-1))


def _cg(op, b: torch.Tensor, tol: float, maxiter: int, info: Optional[dict]) -> torch.Tensor:
    """``jax.scipy.sparse.linalg.cg(op, b, tol=tol, maxiter=maxiter)`` with
    M = identity, for one array ``b`` (all of it one system)."""
    atol2 = torch.clamp_min(tol**2 * _vdot(b, b), 0.0)
    x = torch.zeros_like(b)
    r = b - op(x)
    p = r
    gamma = _vdot(r, r)
    steps = torch.zeros((), dtype=torch.int64, device=b.device)
    for k in range(maxiter):
        active = gamma > atol2
        if k % _CHECK_EVERY == 0 and not bool(active):
            break
        ap = op(p)
        alpha = torch.where(active, gamma / _vdot(p, ap), 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        gamma_new = _vdot(r, r)
        beta = gamma_new / gamma
        p = torch.where(active, r + beta * p, p)
        gamma = torch.where(active, gamma_new, gamma)
        steps += active
    if info is not None:
        info["iterations"] = int(steps)
        info["residual"] = float(gamma.sqrt() / _vdot(b, b).sqrt())
    return x


def solve_darcy(a: torch.Tensor, f: torch.Tensor, tol: float = 1e-8, maxiter: int = 2000,
                info: Optional[dict] = None) -> torch.Tensor:
    """a, f: (..., K, K) -> p (..., K, K) with zero boundary, in f32 on
    ``a``'s device.  ``info``, if given, receives the CG step count
    (``iterations``) and the final relative recursive residual
    (``residual``, |r| / |b|)."""
    a, f = a.float(), f.float()
    k = a.shape[-1]
    h2inv = float((k - 1) ** 2)
    mask = torch.zeros((k, k), device=a.device)
    mask[1:-1, 1:-1] = 1.0
    rhs = f * mask
    edges = _edges(a)

    def op(p):
        return _apply_edges(edges, p * mask, h2inv)

    return _cg(op, rhs, tol, maxiter, info) * mask


def generate_darcy_batch(
    generator: torch.Generator,
    n: int,
    s: int,
    alpha: float = 2.0,
    tau: float = 3.0,
    coef_mode: str = "threshold",
    maxiter: int = 2000,
    device=None,
    info: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample (coefficients, solutions) like the reference's demo.m:
    thresholded (12 / 4) or lognormal (exp of the GRF) coefficients,
    forcing f = 1.  The GRF's noise comes from ``generator``; the synthesis
    and the solve run on ``device`` (default: the generator's)."""
    g = darcy_grf(generator, n, s, alpha, tau, device)
    if coef_mode == "lognormal":
        a = torch.exp(g)
    elif coef_mode == "threshold":
        a = torch.where(g >= 0, 12.0, 4.0)
    else:
        raise ValueError(coef_mode)
    f = torch.ones((n, s, s), device=a.device)
    return a, solve_darcy(a, f, maxiter=maxiter, info=info)
