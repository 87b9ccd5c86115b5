"""The mesh of ranks on ``torch.distributed`` (port of ``uno_tpu/parallel``):
data parallelism, spatial domain decomposition and channel tensor
parallelism.

``uno_tpu``'s ``batch_sharding`` and ``replicated`` return
``NamedSharding`` objects for ``device_put``; the port's ranks take their
rows with ``shard_batch`` / ``batch_spatial_sharding`` and their weights
with ``replicate`` / ``place_state`` instead.  ``process_local_batch`` is
``local_rows``.
"""

from uno_tpu_torch.parallel.distributed import initialize_from_env, is_multiprocess, local_rows
from uno_tpu_torch.parallel.mesh import (
    DataParallel,
    batch_spatial_sharding,
    make_mesh,
    replicate,
    shard_batch,
)
from uno_tpu_torch.parallel.shmap import all_reduce_sum, dp_value_and_grad
from uno_tpu_torch.parallel.spatial import (
    Axis,
    Split,
    count_once,
    gather_channels,
    gather_rows,
    partition,
    psum,
)
from uno_tpu_torch.parallel.tp import place_state, shard_state_tp, tp_spec

__all__ = [
    "Axis",
    "DataParallel",
    "Split",
    "all_reduce_sum",
    "batch_spatial_sharding",
    "count_once",
    "dp_value_and_grad",
    "gather_channels",
    "gather_rows",
    "initialize_from_env",
    "is_multiprocess",
    "local_rows",
    "make_mesh",
    "partition",
    "place_state",
    "psum",
    "replicate",
    "shard_batch",
    "shard_state_tp",
    "tp_spec",
]
