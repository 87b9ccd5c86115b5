"""Explicit-collective data parallelism (port of
``uno_tpu/parallel/shmap.py``).

Each rank runs the backward of a loss summed (not averaged) over its own
rows; then the loss and every gradient are summed over the ranks, which
gives exactly the one-process loss and gradients of the global batch, as
``uno_tpu``'s ``psum`` over ``data`` does.  torch's
``DistributedDataParallel`` averages instead (its default hook divides by
the world size), and ``ComplexAdam`` adds the weight decay to the gradient,
so a scaled gradient would change the trajectory.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

import torch
import torch.distributed as dist

from uno_tpu_torch.parallel.mesh import DataParallel


def all_reduce_sum(dp: Optional[DataParallel], tensors: List[torch.Tensor]) -> None:
    """Sum ``tensors`` over the ranks, in place: one ``all_reduce`` per
    dtype, each tensor flattened into its dtype's buffer, a complex one
    viewed as real.  Nothing to do without a process group."""
    if dp is None or dp.group is None:
        return
    buckets = {}
    for t in tensors:
        r = torch.view_as_real(t) if t.is_complex() else t
        buckets.setdefault(r.dtype, []).append(r)
    for group in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat, group=dp.group)
        for t, v in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(v.view_as(t))


def dp_value_and_grad(loss_fn: Callable, dp: Optional[DataParallel],
                      params: Iterable[torch.nn.Parameter], has_aux: bool = False):
    """Returns ``fn(*args) -> (loss, grads)``, or ``((loss, aux), grads)``
    with ``has_aux`` when ``loss_fn`` returns ``(loss, aux)``.

    ``loss_fn`` computes this rank's loss, a sum over its rows; ``fn`` runs
    its backward into the parameters' ``.grad`` and then sums the detached
    loss and the gradients over the ranks (``all_reduce_sum``).  The grads
    returned are the parameters' ``.grad`` tensors.  Without ``dp`` (or
    without a process group) it is the plain backward."""
    params = [p for p in params if p.requires_grad]

    def fn(*args):
        out = loss_fn(*args)
        loss, aux = out if has_aux else (out, None)
        loss.backward()
        loss = loss.detach()
        grads = [p.grad for p in params if p.grad is not None]
        all_reduce_sum(dp, [loss, *grads])
        return ((loss, aux) if has_aux else loss), grads

    return fn
