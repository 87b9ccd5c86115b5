"""Multi-process set-up for data parallelism (port of
``uno_tpu/parallel/distributed.py``).

One process per rank, as a launcher (``torchrun``) or a script starts them.
``initialize_from_env`` joins the ranks in one ``torch.distributed`` process
group; the caller names the backend: ``nccl`` on the card, ``gloo`` on the
CPU (gloo also takes CUDA tensors, staged through the host, which lets two
ranks share one card).  Explicit arguments win; otherwise it reads torch's
launcher variables or ``uno_tpu``'s spellings of the same things:

======================  ====================  ==========================
meaning                 torch's launcher      ``uno_tpu``'s spelling
======================  ====================  ==========================
where rank 0 listens    ``MASTER_ADDR`` and   ``COORDINATOR_ADDRESS``
                        ``MASTER_PORT``       (``host:port``)
number of ranks         ``WORLD_SIZE``        ``NUM_PROCESSES``
this process's rank     ``RANK``              ``PROCESS_ID``
its card on the host    ``LOCAL_RANK``        (read by ``make_mesh``)
======================  ====================  ==========================

With none of them set it does nothing and returns False, so a single-process
run pays nothing.  A world of one needs no address: it listens on a free
local port.

``local_rows`` replaces ``process_local_batch``: every rank draws the same
global batch (the trainers' permutation is seeded) and keeps the rows that
``NamedSharding(mesh, P("data"))`` gives device ``rank`` of a 1-D ``data``
mesh: contiguous equal blocks, in rank order.
"""

from __future__ import annotations

import os
import socket
from typing import Optional

import torch.distributed as dist


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def initialize_from_env(
    backend: str,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
) -> bool:
    """Join the default process group when the environment (or the
    arguments) describe one; idempotent.  Returns True when the group is
    (now) initialized."""
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None:
        if env.get("MASTER_ADDR") or env.get("MASTER_PORT"):
            init_method = (f"tcp://{env.get('MASTER_ADDR') or 'localhost'}:"
                           f"{env.get('MASTER_PORT') or 29500}")
        elif env.get("COORDINATOR_ADDRESS"):
            init_method = f"tcp://{env['COORDINATOR_ADDRESS']}"
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE", "NUM_PROCESSES")
    rank = rank if rank is not None else _env_int("RANK", "PROCESS_ID")
    if init_method is None and world_size is None and rank is None:
        return False
    if init_method is None and world_size == 1:
        init_method = f"tcp://localhost:{_free_port()}"
    missing = [name for name, v in (("address", init_method), ("world size", world_size),
                                    ("rank", rank)) if v is None]
    if missing:
        raise ValueError(f"initialize_from_env: the environment names a process group but "
                         f"not its {', '.join(missing)} (MASTER_ADDR/MASTER_PORT, WORLD_SIZE, "
                         f"RANK, or COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID)")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return True


def is_multiprocess() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def local_rows(global_idx, rank: int, world: int):
    """Rank ``rank``'s rows of a global batch over ``world`` ranks: the
    ``rank``-th of ``world`` contiguous equal blocks.  The batch must split
    evenly (the trainers drop a remainder batch and ask for a batch size
    that the world divides)."""
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"rank {rank} of a world of {world}")
    n = len(global_idx)
    if n % world:
        raise ValueError(f"a batch of {n} rows does not split evenly over {world} ranks")
    per = n // world
    return global_idx[rank * per : (rank + 1) * per]
