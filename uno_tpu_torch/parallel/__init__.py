"""Data parallelism on ``torch.distributed`` (port of ``uno_tpu/parallel``).

``uno_tpu``'s spatial axis and channel tensor parallelism (``tp.py``) are
not ported yet: ROADMAP.md Queue 1 item 8.
"""

from uno_tpu_torch.parallel.distributed import initialize_from_env, is_multiprocess, local_rows
from uno_tpu_torch.parallel.mesh import DataParallel, make_mesh, replicate, shard_batch
from uno_tpu_torch.parallel.shmap import all_reduce_sum, dp_value_and_grad

__all__ = [
    "DataParallel",
    "all_reduce_sum",
    "dp_value_and_grad",
    "initialize_from_env",
    "is_multiprocess",
    "local_rows",
    "make_mesh",
    "replicate",
    "shard_batch",
]
