"""Pseudo-spectral 2-D Navier–Stokes solver in vorticity form (port of
``uno_tpu/data/ns_solver.py``).

The reference generator (Data Generation/Navier Stocks/ns_datagen.py:15-140)
as ``uno_tpu`` writes it: the state lives in Fourier space as complex64;
each step solves the stream function by a Fourier Poisson solve (``lap[0, 0]
= 1``), takes velocities and vorticity gradients by spectral
differentiation, dealiases the nonlinear term by the 2/3 rule and updates
with Crank–Nicolson for the viscous term.  Full complex FFTs, as in
``uno_tpu``.

``uno_tpu``'s ``lax.scan`` is a loop here that queues every step's kernels
on the state's device and never waits for it: nothing is read back until the
caller reads the result.  The factors that do not change over the run
(``2 pi i k``, the Crank–Nicolson numerator and denominator, ``dt f``) are
formed once, with the same operations and operand order as ``uno_tpu``'s
step, so they hold the same values.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def default_forcing(s: int, device=None) -> torch.Tensor:
    """0.1*(sin(2π(x+y)) + cos(2π(x+y))) on the [0,1) grid (ns_datagen.py:165-169)."""
    t = np.linspace(0, 1, s + 1)[:-1]
    xx, yy = np.meshgrid(t, t, indexing="ij")
    f = 0.1 * (np.sin(2 * math.pi * (xx + yy)) + np.cos(2 * math.pi * (xx + yy)))
    return torch.as_tensor(f, dtype=torch.float32, device=device)


def _solve(w0: torch.Tensor, f: torch.Tensor, visc: float, delta_t: float,
           record_steps: int, steps_per_record: int) -> torch.Tensor:
    n = w0.shape[-1]
    k_max = n // 2
    dev = w0.device

    k = torch.cat([torch.arange(0, k_max, device=dev),
                   torch.arange(-k_max, 0, device=dev)]).float()
    k_y = k[None, :].expand(n, n)
    k_x = k[:, None].expand(n, n)
    lap = 4.0 * (math.pi**2) * (k_x**2 + k_y**2)
    lap[0, 0] = 1.0
    dealias = ((k_y.abs() <= (2.0 / 3.0) * k_max)
               & (k_x.abs() <= (2.0 / 3.0) * k_max)).float()

    w_h = torch.fft.fft2(w0.float()).to(torch.complex64)
    f_h = torch.fft.fft2(f.float()).to(torch.complex64)

    two_pi_i = 2.0 * math.pi * 1j
    d_y = two_pi_i * k_y      # u = psi_y
    d_x_neg = -two_pi_i * k_x  # v = -psi_x
    d_x = two_pi_i * k_x
    dt_f_h = delta_t * f_h
    cn_num = 1.0 - 0.5 * delta_t * visc * lap
    cn_den = 1.0 + 0.5 * delta_t * visc * lap

    sol = torch.empty((record_steps,) + tuple(w0.shape), dtype=torch.float32, device=dev)
    for r in range(record_steps):
        for _ in range(steps_per_record):
            psi_h = w_h / lap
            q = torch.fft.ifft2(d_y * psi_h).real
            v = torch.fft.ifft2(d_x_neg * psi_h).real
            w_x = torch.fft.ifft2(d_x * w_h).real
            w_y = torch.fft.ifft2(d_y * w_h).real
            f_nl = torch.fft.fft2(q * w_x + v * w_y).to(torch.complex64) * dealias
            num = -delta_t * f_nl + dt_f_h + cn_num * w_h
            w_h = num / cn_den
        sol[r] = torch.fft.ifft2(w_h).real
    # (record_steps, B, n, n) -> (B, n, n, record_steps)
    return sol.movedim(0, -1).contiguous()


def navier_stokes_2d(
    w0: torch.Tensor,
    f: torch.Tensor,
    visc: float,
    T: float,
    delta_t: float = 1e-4,
    record_steps: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integrate vorticity w0 (B, N, N) to time T on w0's device; returns
    (sol (B, N, N, record_steps) f32, sol_t (record_steps,) f32).  As in
    ``uno_tpu``, it takes ``ceil(T / delta_t) // record_steps`` steps per
    record, so the run ends at ``sol_t[-1]``."""
    steps = math.ceil(T / delta_t)
    steps_per_record = steps // record_steps
    sol = _solve(w0, f.to(w0.device), float(visc), float(delta_t), record_steps,
                 steps_per_record)
    sol_t = torch.arange(1, record_steps + 1, dtype=torch.float32) * (
        steps_per_record * delta_t)
    return sol, sol_t
