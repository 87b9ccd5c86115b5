"""Complex-parameter-aware Adam and the StepLR schedule (port of
``uno_tpu/optim.py``).

The reference ships a custom Adam (Adam.py:8-52) whose only deviation from
stock torch-1.11 Adam is the second-moment update
``nu += (1-b2) * grad * grad.conj()``.  Weight decay is **non-decoupled L2**:
``grad = grad + wd * param`` applied before the moment updates, complex
leaves included.  Per parameter:

* ``mu`` (``exp_avg``)    — same dtype as the parameter (complex for the
  spectral weights);
* ``nu`` (``exp_avg_sq``) — always real: ``|g|^2 = re^2 + im^2``, one second
  moment shared by the re and im parts of a complex weight;
* update — ``-lr/bc1 * mu / (sqrt(nu)/sqrt(bc2) + eps)`` with the 1-based
  step count in the bias corrections ``bc = 1 - beta**count``.

The gradients are torch autograd's, which for a complex parameter and a real
loss is already the descent direction (the conjugate-Wirtinger gradient), so
this optimizer does **not** conjugate.  ``uno_tpu``'s ``complex_adam``
conjugates because ``jax.grad`` returns the conjugate; both take the same
step from the same loss.

``uno_tpu``'s ``fused=True`` (per-dtype flattened buffers) exists to cut the
TPU's dispatch count and is not ported.
"""

from __future__ import annotations

from typing import Callable, Union

import torch


def step_lr(
    base_lr: float,
    step_size_epochs: int,
    gamma: float,
    steps_per_epoch: int,
) -> Callable[[int], float]:
    """StepLR as a schedule over the 1-based optimizer step count:
    ``lr(count) = base_lr * gamma ** (epoch // step_size_epochs)`` with
    ``epoch = (count - 1) // steps_per_epoch``, the trajectory of torch's
    StepLR stepped once per epoch."""

    def schedule(count: int) -> float:
        epoch = max(count - 1, 0) // steps_per_epoch
        return base_lr * gamma ** (epoch // step_size_epochs)

    return schedule


def _abs2(g: torch.Tensor) -> torch.Tensor:
    """``re(g * conj(g))``: |g|^2, real, for real and complex g."""
    if g.is_complex():
        return torch.view_as_real(g).square().sum(dim=-1)
    return g * g


class ComplexAdam(torch.optim.Optimizer):
    """Reference-parity Adam over real and complex parameters.

    ``lr`` is a number or a schedule, a function of the 1-based step count
    (``step_lr``).  ``amsgrad`` divides by the running maximum of ``nu``.
    """

    def __init__(
        self,
        params,
        lr: Union[float, Callable[[int], float]] = 1e-3,
        betas=(0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        amsgrad: bool = False,
    ):
        defaults = dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                        amsgrad=amsgrad)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            wd, eps, amsgrad = group["weight_decay"], group["eps"], group["amsgrad"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    real = dict(dtype=p.real.dtype, device=p.device)
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros(p.shape, **real)
                    if amsgrad:
                        state["max_exp_avg_sq"] = torch.zeros(p.shape, **real)
                if wd != 0.0:
                    g = g + wd * p
                state["step"] += 1
                count = state["step"]
                mu, nu = state["exp_avg"], state["exp_avg_sq"]
                mu.mul_(b1).add_(g, alpha=1.0 - b1)
                nu.mul_(b2).add_(_abs2(g), alpha=1.0 - b2)
                if amsgrad:
                    torch.maximum(state["max_exp_avg_sq"], nu, out=state["max_exp_avg_sq"])
                    nu = state["max_exp_avg_sq"]
                lr = group["lr"](count) if callable(group["lr"]) else group["lr"]
                bc1 = 1.0 - b1**count
                bc2 = 1.0 - b2**count
                denom = nu.sqrt().div_(bc2**0.5).add_(eps)
                p.add_(mu / denom, alpha=-lr / bc1)
        return loss
