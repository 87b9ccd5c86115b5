"""Data-parallel ranks (port of ``uno_tpu/parallel/mesh.py``).

``uno_tpu`` builds a ``jax.sharding.Mesh`` with a ``data`` and a ``spatial``
axis and lets XLA insert the gradient reduction.  Here a ``DataParallel``
record (the process group, this process's rank, the world size and its
device) takes the place of the mesh: each process is one rank of the
``data`` axis, holds a full replica of the model, and the trainers sum the
loss and the gradients over the ranks explicitly (``parallel/shmap.py``).
The ``spatial`` axis (domain decomposition, channel tensor parallelism) is
not ported yet: ROADMAP.md Queue 1 item 8.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional, Union

import torch
import torch.distributed as dist
from torch import nn

from uno_tpu_torch.parallel.distributed import local_rows


@dataclass(frozen=True)
class DataParallel:
    """One rank of the ``data`` axis.  ``group`` is None in a single
    process with no process group: then there is nothing to reduce."""

    group: Optional[Any]
    rank: int
    world: int
    device: torch.device

    @property
    def main(self) -> bool:
        """Rank 0: the one that logs and writes checkpoints."""
        return self.rank == 0


def make_mesh(n_data: Optional[int] = None, n_spatial: int = 1,
              device: Union[str, torch.device] = "cuda") -> DataParallel:
    """This process's rank of a ``data`` axis over every rank of the
    default process group (one rank when there is none).  ``device``
    without an index on CUDA means ``cuda:LOCAL_RANK``."""
    if n_spatial != 1:
        raise NotImplementedError(
            f"a spatial mesh axis ({n_spatial}) is not ported yet: ROADMAP.md Queue 1 "
            "item 8 (spatial decomposition and channel tensor parallelism on DTensor)")
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if n_data is None:
        n_data = world
    if n_data != world:
        raise ValueError(f"a data axis of {n_data} needs {n_data} ranks, one per process; "
                         f"the process group has {world}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK") or 0))
    return DataParallel(dist.group.WORLD if initialized else None, rank, world, dev)


def _real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


def replicate(dp: Optional[DataParallel], module: nn.Module) -> nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0, in place,
    so that every rank starts from the same weights."""
    if dp is not None and dp.group is not None:
        with torch.no_grad():
            for t in [*module.parameters(), *module.buffers()]:
                dist.broadcast(_real(t.data), src=0, group=dp.group)
    return module


def shard_batch(dp: Optional[DataParallel], global_idx):
    """This rank's rows of a global batch (all of it without ``dp``)."""
    return global_idx if dp is None else local_rows(global_idx, dp.rank, dp.world)
