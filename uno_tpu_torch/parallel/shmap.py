"""Explicit-collective data parallelism (port of
``uno_tpu/parallel/shmap.py``), and the gradient rule of the mesh's
``spatial`` axis.

Each rank runs the backward of a loss summed (not averaged) over its own
rows; then the loss and every gradient are summed over the ranks, which
gives exactly the one-process loss and gradients of the global batch, as
``uno_tpu``'s ``psum`` over ``data`` does.  torch's
``DistributedDataParallel`` averages instead (its default hook divides by
the world size), and ``ComplexAdam`` adds the weight decay to the gradient,
so a scaled gradient would change the trajectory.

On a mesh with a ``spatial`` axis the ranks of that axis share one model
and each holds the loss whole, so the backward is seeded on the axis's rank
0 only (``parallel/spatial.py`` ``count_once``), the gradients of the
parameters that the axis's ranks hold whole are summed over the whole mesh,
a sharded parameter's (channel TP) over ``data`` only, and the loss over
``data`` only.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

import torch
import torch.distributed as dist

from uno_tpu_torch.parallel.mesh import DataParallel
from uno_tpu_torch.parallel.spatial import count_once
from uno_tpu_torch.utils.profiling import annotate


def _sum_over(group, tensors: List[torch.Tensor]) -> None:
    """Sum ``tensors`` over ``group``, in place: one ``all_reduce`` per
    dtype, each tensor flattened into its dtype's buffer, a complex one
    viewed as real; one ``allreduce`` span.  Nothing to do without a
    group."""
    if group is None:
        return
    buckets = {}
    for t in tensors:
        r = torch.view_as_real(t) if t.is_complex() else t
        buckets.setdefault(r.dtype, []).append(r)
    with annotate("allreduce"):
        for bucket in buckets.values():
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat, group=group)
            for t, v in zip(bucket, flat.split([t.numel() for t in bucket])):
                t.copy_(v.view_as(t))


def all_reduce_sum(dp: Optional[DataParallel], tensors: List[torch.Tensor]) -> None:
    """Sum ``tensors`` over the ``data`` axis, in place (``_sum_over``)."""
    if dp is not None:
        _sum_over(dp.group, tensors)


def dp_value_and_grad(loss_fn: Callable, dp: Optional[DataParallel],
                      params: Iterable[torch.nn.Parameter], has_aux: bool = False,
                      sharded: Iterable[torch.nn.Parameter] = ()):
    """Returns ``fn(*args) -> (loss, grads)``, or ``((loss, aux), grads)``
    with ``has_aux`` when ``loss_fn`` returns ``(loss, aux)``.

    ``loss_fn`` computes this rank's loss, a sum over its rows of the batch
    (whole on every rank of a spatial axis); ``fn`` runs its backward into
    the parameters' ``.grad``, then sums the detached loss over ``data``
    and the gradients over the mesh (``sharded``: the parameters that hold
    a channel shard, summed over ``data`` only).  The grads returned are the
    parameters' ``.grad`` tensors.  Without ``dp`` (or without a process
    group) it is the plain backward.  A call is one ``grad`` span, its
    backward a ``backward`` span inside it."""
    params = [p for p in params if p.requires_grad]
    sharded = {id(p) for p in sharded}

    @annotate("grad")
    def fn(*args):
        out = loss_fn(*args)
        loss, aux = out if has_aux else (out, None)
        with annotate("backward"):
            count_once(loss, 0 if dp is None else dp.spatial_rank).backward()
        loss = loss.detach()
        grads = [p.grad for p in params if p.grad is not None]
        if dp is not None:
            whole = [p.grad for p in params if p.grad is not None and id(p) not in sharded]
            shards = [p.grad for p in params if p.grad is not None and id(p) in sharded]
            _sum_over(dp.group, [loss, *shards])
            _sum_over(dp.mesh_group, whole)
        return ((loss, aux) if has_aux else loss), grads

    return fn
