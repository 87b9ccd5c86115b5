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

``fused=True`` is ``uno_tpu``'s ``complex_adam(fused=True)``: the same
elementwise sequence on one flat buffer per parameter dtype of a group, a
dozen launches a dtype instead of about ten a parameter.  Its state is
flat, so a checkpoint of one form does not load into the other.

``step`` is the ``optimizer`` span (``utils/profiling.py``) in either form.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

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


def _abs2(g: torch.Tensor) -> torch.Tensor:
    """``re(g * conj(g))``: |g|^2, real, for real and complex g."""
    if g.is_complex():
        return torch.view_as_real(g).square().sum(dim=-1)
    return g * g


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

    ``fused=True`` keeps, for each parameter group and each parameter dtype
    in it, one flat ``exp_avg`` and one flat real ``exp_avg_sq`` (and
    ``max_exp_avg_sq``) over all the group's parameters of that dtype, in
    their order, under ``state["flat<group>"]`` with the group's step count.
    A step gathers the gradients of a dtype with one ``torch.cat``, runs
    the per-parameter sequence on the flat buffers and adds the update to
    the parameters with one ``torch._foreach_add_``: the same operations on
    the same numbers, bit for bit.  Each step needs a gradient for every
    parameter of a group or for none.  That state does not load into a
    ``fused=False`` optimizer, nor the other way round.
    """

    def __init__(
        self,
        params,
        lr: Union[float, Callable[[int], float]] = 1e-3,
        betas=(0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        amsgrad: bool = False,
        fused: bool = False,
    ):
        defaults = dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                        amsgrad=amsgrad)
        super().__init__(params, defaults)
        self.fused = fused

    @staticmethod
    def _update(group: dict, count: int, g, p, state: dict) -> torch.Tensor:
        """Advance ``state``'s moments by gradient ``g`` of parameter ``p``
        (tensors, or flat buffers of the same elements); returns the update
        before its factor ``-lr / bc1`` (``_step_size``)."""
        b1, b2 = group["betas"]
        if group["weight_decay"] != 0.0:
            g = g + group["weight_decay"] * p
        mu, nu = state["exp_avg"], state["exp_avg_sq"]
        mu.mul_(b1).add_(g, alpha=1.0 - b1)
        nu.mul_(b2).add_(_abs2(g), alpha=1.0 - b2)
        if group["amsgrad"]:
            torch.maximum(state["max_exp_avg_sq"], nu, out=state["max_exp_avg_sq"])
            nu = state["max_exp_avg_sq"]
        bc2 = 1.0 - b2**count
        denom = nu.sqrt().div_(bc2**0.5).add_(group["eps"])
        return mu / denom

    @staticmethod
    def _step_size(group: dict, count: int) -> float:
        lr = group["lr"](count) if callable(group["lr"]) else group["lr"]
        return -lr / (1.0 - group["betas"][0] ** count)

    @annotate("optimizer")
    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for i, group in enumerate(self.param_groups):
            if self.fused:
                self._fused_step(i, group)
                continue
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(step=0, **_zero_state(p, group["amsgrad"]))
                state["step"] += 1
                count = state["step"]
                p.add_(self._update(group, count, p.grad, p, state),
                       alpha=self._step_size(group, count))
        return loss

    def _fused_step(self, i: int, group: dict) -> None:
        params = [p for p in group["params"] if p.grad is not None]
        if not params:
            return
        if len(params) != len(group["params"]):
            raise ValueError(f"ComplexAdam(fused=True): group {i} has gradients for "
                             f"{len(params)} of its {len(group['params'])} parameters")
        by_dtype = {}
        for p in params:
            by_dtype.setdefault(str(p.dtype), []).append(p)
        flat = self.state[f"flat{i}"]
        if not flat:
            flat["step"] = 0
            for dt, ps in by_dtype.items():
                n = sum(p.numel() for p in ps)
                flat[dt] = _zero_state(ps[0].new_empty(n), group["amsgrad"])
        flat["step"] += 1
        count = flat["step"]
        for dt, ps in by_dtype.items():
            g = torch.cat([p.grad.reshape(-1) for p in ps])
            pf = torch.cat([p.reshape(-1) for p in ps]) if group["weight_decay"] else None
            upd = self._update(group, count, g, pf, flat[dt])
            views = [u.view_as(p) for u, p in zip(upd.split([p.numel() for p in ps]), ps)]
            torch._foreach_add_(ps, views, alpha=self._step_size(group, count))

    def load_state_dict(self, state_dict: dict) -> None:
        """torch's, after checking that the state is of this optimizer's
        form; flat buffers go to their group's device."""
        if any(isinstance(k, str) != self.fused for k in state_dict["state"]):
            raise ValueError(f"the state of a fused={not self.fused} ComplexAdam does not load "
                             f"into a fused={self.fused} one")
        super().load_state_dict(state_dict)
        for i, group in enumerate(self.param_groups):
            st = self.state.get(f"flat{i}")
            if st:
                dev = group["params"][0].device
                for dt, bufs in st.items():
                    if dt != "step":
                        st[dt] = {k: v.to(dev) for k, v in bufs.items()}
