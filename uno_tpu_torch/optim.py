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

The moments are each parameter's own tensors.  ``uno_tpu``'s
``complex_adam(fused=True)``, its moments in one flat buffer per dtype, has
no counterpart here: the step of a group is already one kernel launch on
the card.

A group's step goes to ``ops/kernels/adam.py``: on the card one launch of
a hand-written kernel over all the group's parameters, on the CPU the
plain sequence of torch ops a parameter at a time; both run the same
arithmetic on each element.

``step`` is the ``optimizer`` span (``utils/profiling.py``).
"""

from __future__ import annotations

from typing import Callable, Union

import torch

from uno_tpu_torch.ops.kernels import adam
from uno_tpu_torch.utils.profiling import annotate


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


def _zero_state(like: torch.Tensor, amsgrad: bool) -> dict:
    """``mu`` in ``like``'s dtype, ``nu`` (and ``max_nu``) real."""
    real = dict(dtype=like.real.dtype, device=like.device)
    state = {"exp_avg": torch.zeros_like(like),
             "exp_avg_sq": torch.zeros(like.shape, **real)}
    if amsgrad:
        state["max_exp_avg_sq"] = torch.zeros(like.shape, **real)
    return state


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

    @annotate("optimizer")
    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            states, slots = self._slots(group)
            if slots:
                adam.adam_step(group, slots)
            for state in states:  # counted once the step is taken: a refused one is not
                state["step"] += 1
        return loss

    def _slots(self, group: dict) -> tuple:
        """(the states whose count the step advances, the step's slots)."""
        states, slots = [], []
        for p in group["params"]:
            if p.grad is None:
                continue
            state = self.state[p]
            if not state:
                state.update(step=0, **_zero_state(p, group["amsgrad"]))
            states.append(state)
            slots.append(adam.Slot(p, p.grad, state["exp_avg"], state["exp_avg_sq"],
                                   state.get("max_exp_avg_sq"), state["step"] + 1))
        return states, slots
