"""A module-scoped autouse fixture for the port's CPU-heavy 3-D test files:
under pytest-xdist the workers share the host's cores, and torch's intra-op
threads default to every core in each of them, so pocketfft starts a full
set of threads for every small multi-axis transform.  While a module that
imports it runs, torch takes the worker's share of the cores; its threads
are restored after.  Spawned processes are not touched (no
``OMP_NUM_THREADS``), and nothing changes without xdist.

    from _threads import worker_share_of_threads  # noqa: F401
"""

from __future__ import annotations

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def worker_share_of_threads():
    threads = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(threads)
