"""The (data x spatial) mesh of ranks (port of ``uno_tpu/parallel/mesh.py``).

``uno_tpu`` builds a ``jax.sharding.Mesh`` with a ``data`` and a ``spatial``
axis and lets XLA insert the collectives.  Here a ``DataParallel`` record
takes the place of the mesh: each process is one rank, laid out row-major
over (data, spatial) as ``np.asarray(devices).reshape(n_data, n_spatial)``
lays out ``uno_tpu``'s devices, with a process group for each axis through
it.  Along ``data`` each rank runs its rows of every global batch and the
trainers sum the loss and the gradients over the axis explicitly
(``parallel/shmap.py``).  Along ``spatial`` the ranks share one model:
either each holds its rows of the leading grid axis (domain decomposition,
``parallel/spatial.py``) or, under channel tensor parallelism, its shard of
every weight's out-channel axis (``parallel/tp.py``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional, Union

import torch
import torch.distributed as dist
from torch import nn

from uno_tpu_torch.parallel.distributed import local_rows
from uno_tpu_torch.parallel.spatial import Axis


@dataclass(frozen=True)
class DataParallel:
    """One rank of the mesh.  ``group``, ``rank`` and ``world`` are its
    ``data`` axis (``group`` is None when the axis has one rank: then there
    is nothing to reduce over it); ``spatial`` is its place on the
    ``spatial`` axis (None when that axis has one rank); ``mesh_group``
    holds every rank of the mesh (None in a single process)."""

    group: Optional[Any]
    rank: int
    world: int
    device: torch.device
    spatial: Optional[Axis] = None
    mesh_group: Optional[Any] = None

    def __post_init__(self):
        if self.mesh_group is None and self.spatial is None:
            object.__setattr__(self, "mesh_group", self.group)

    @property
    def main(self) -> bool:
        """The mesh's rank 0: the one that logs and writes checkpoints."""
        return self.rank == 0 and (self.spatial is None or self.spatial.rank == 0)

    @property
    def spatial_rank(self) -> int:
        return 0 if self.spatial is None else self.spatial.rank


def make_mesh(n_data: Optional[int] = None, n_spatial: int = 1,
              device: Union[str, torch.device] = "cuda") -> DataParallel:
    """This process's rank of a (data x spatial) mesh over every rank of the
    default process group (one rank when there is none), laid out
    row-major: global rank ``d * n_spatial + s`` is data rank ``d``,
    spatial rank ``s``.  ``n_data`` defaults to the ranks over
    ``n_spatial``.  ``device`` without an index on CUDA means
    ``cuda:LOCAL_RANK``.  Every process of the group must call it (each
    axis's groups are made collectively)."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if n_spatial < 1:
        raise ValueError(f"a spatial axis of {n_spatial}")
    if n_data is None:
        n_data = world // n_spatial
    if n_data < 1 or n_data * n_spatial != world:
        raise ValueError(f"a mesh of {n_data} data x {n_spatial} spatial needs "
                         f"{max(n_data, 1) * n_spatial} ranks, one per process; the process "
                         f"group has {world}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK") or 0))
    d, s = divmod(rank, n_spatial)
    if n_spatial == 1:
        return DataParallel(dist.group.WORLD if initialized else None, rank, world, dev)
    # every process makes every group, in the same order
    data_group = spatial_group = None
    for s_ in range(n_spatial):
        g = dist.new_group([d_ * n_spatial + s_ for d_ in range(n_data)])
        if s_ == s:
            data_group = g
    for d_ in range(n_data):
        g = dist.new_group([d_ * n_spatial + s_ for s_ in range(n_spatial)])
        if d_ == d:
            spatial_group = g
    return DataParallel(data_group if n_data > 1 else None, d, n_data, dev,
                        Axis(spatial_group, s, n_spatial), dist.group.WORLD)


def _real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


def replicate(dp: Optional[DataParallel], module: nn.Module) -> nn.Module:
    """Broadcast ``module``'s parameters and buffers from the mesh's rank
    0, in place, so that every rank starts from the same weights."""
    if dp is not None and dp.mesh_group is not None:
        with torch.no_grad():
            for t in [*module.parameters(), *module.buffers()]:
                dist.broadcast(_real(t.data), src=0, group=dp.mesh_group)
    return module


def shard_batch(dp: Optional[DataParallel], global_idx):
    """This rank's rows of a global batch (all of it without ``dp``): its
    block of the ``data`` axis."""
    return global_idx if dp is None else local_rows(global_idx, dp.rank, dp.world)


def batch_spatial_sharding(dp: Optional[DataParallel], x, rows=None):
    """This rank's rows of the leading grid axis (axis 1) of a batch ``x``,
    the counterpart of ``NamedSharding(mesh, P("data", "spatial"))`` after
    ``shard_batch`` took the batch's rows: ``rows`` (lo, hi), by default the
    ``parallel/spatial.py`` partition of the axis (a model's input takes
    ``UNOModel.input_rows``).  All of it without a spatial axis."""
    if dp is None or dp.spatial is None:
        return x
    lo, hi = rows if rows is not None else dp.spatial.split(x.shape[1]).rows()
    return x[:, lo:hi]
