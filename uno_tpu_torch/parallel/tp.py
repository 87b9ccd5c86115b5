"""Channel tensor parallelism (port of ``uno_tpu/parallel/tp.py``).

``uno_tpu`` shards every parameter's out-channel axis over the mesh's
``spatial`` axis with ``NamedSharding`` and lets GSPMD partition each layer.
Here each rank of that axis holds its shard as the ``nn.Parameter`` itself
(so ``ComplexAdam``'s moments, made like the parameter, are sharded with
it, as ``place_state`` shards ``mu``/``nu``), and each sharded layer
computes its out-channel shard from all of its input channels and gathers
the channels where the next layer reads all of them
(``parallel/spatial.py`` ``gather_channels``; ``nn/layers.py``).

Out-channel axes by parameter name, in the port's layout (a Dense or 1x1
conv ``weight`` is ``(out, in)``, where ``uno_tpu``'s ``kernel`` is ``(in,
out)``; ``uno_tpu_torch/bridge.py`` transposes):

* ``weight``                — Dense / PointwiseOp, ``(out, in)``       -> axis 0
* ``weights``               — SpectralConv, ``(blocks, Ci, Co, *modes)`` -> axis 2
* ``bias`` / ``norm_scale`` / ``norm_bias`` — ``(out,)``               -> axis 0

An axis that the rank count does not divide, or that is shorter than it,
stays replicated, as in ``uno_tpu`` (the ``out_dim = 1`` projection).  A
layer's weight, bias and norm share one out-channel count, so a layer is
sharded whole or not at all.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from uno_tpu_torch.parallel.mesh import DataParallel, replicate
from uno_tpu_torch.parallel.spatial import Axis, gather_channels

# parameter name -> out-channel axis (nn/layers.py parameter shapes)
_OUT_AXIS = {
    "weight": 0,
    "weights": 2,
    "bias": 0,
    "norm_scale": 0,
    "norm_bias": 0,
}


def tp_spec(name: str, shape, n_tp: int) -> Optional[int]:
    """The axis of parameter ``name`` (its dotted path) and ``shape`` that
    is sharded over ``n_tp`` ranks, or None when it stays replicated: the
    name is unknown, the axis is out of range, or its length does not
    divide ``n_tp`` or is shorter than it."""
    ax = _OUT_AXIS.get(name.rsplit(".", 1)[-1])
    if ax is None or n_tp <= 1 or len(shape) <= ax or shape[ax] % n_tp or shape[ax] < n_tp:
        return None
    return ax


def sharded_axes(model: nn.Module) -> Dict[str, int]:
    """The sharded parameters of a model placed by ``shard_state_tp``
    (name -> axis); empty otherwise."""
    return dict(getattr(model, "tp_axes", {}))


def shard_state_tp(axis: Axis, model: nn.Module) -> nn.Module:
    """Replace every shardable parameter of ``model`` by this rank's shard
    of its out-channel axis, in place, and tell each layer with sharded
    parameters its ``tp`` axis.  Call before the optimizer is made."""
    axes = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            ax = tp_spec(name, p.shape, axis.world)
            if ax is None:
                continue
            n = p.shape[ax] // axis.world
            p.data = p.data.narrow(ax, n * axis.rank, n).clone()
            axes[name] = ax
    for mod_name, mod in model.named_modules():
        own = [n for n, _ in mod.named_parameters(recurse=False)]
        if own and all(f"{mod_name}.{n}".lstrip(".") in axes for n in own):
            mod.tp = axis
    model.tp_axes = axes
    return model


def place_state(dp: Optional[DataParallel], model: nn.Module,
                tensor_parallel: bool = False) -> nn.Module:
    """Trainer-facing placement: every rank starts from the mesh's rank 0
    weights, then under ``tensor_parallel`` keeps its shards."""
    if dp is None:
        return model
    replicate(dp, model)
    if tensor_parallel and dp.spatial is not None:
        shard_state_tp(dp.spatial, model)
    return model


def full_state(model: nn.Module, dp: Optional[DataParallel], state: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """``state`` (a state dict of ``model``, or any dict keyed by its
    parameter names) with every sharded tensor gathered whole: the layout of
    a one-process run.  Every rank of the axis must call it."""
    axes = sharded_axes(model)
    if not axes:
        return state
    with torch.no_grad():
        return {k: gather_channels(v, axes[k], dp.spatial) if k in axes else v
                for k, v in state.items()}


def local_state(model: nn.Module, dp: Optional[DataParallel], state: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """This rank's shards of a whole ``state`` (the inverse of
    ``full_state``)."""
    axes = sharded_axes(model)
    if not axes:
        return state
    out = {}
    for k, v in state.items():
        if k in axes:
            n = v.shape[axes[k]] // dp.spatial.world
            v = v.narrow(axes[k], n * dp.spatial.rank, n).clone()
        out[k] = v
    return out
