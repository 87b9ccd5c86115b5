"""Host-side batch indices for one epoch (port of
``uno_tpu/data/batching.py``).

The same ``numpy`` permutation as ``uno_tpu``'s, so both packages visit the
same batches from the same seed.  The trainer moves each split to the device
once and indexes batches there.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def epoch_batches(
    rng: np.random.Generator,
    n: int,
    batch_size: int,
    shuffle: bool = True,
    drop_remainder: bool = False,
) -> Iterator[np.ndarray]:
    """Yield index arrays for one epoch; draws one permutation from ``rng``
    when ``shuffle``, nothing otherwise."""
    idx = rng.permutation(n) if shuffle else np.arange(n)
    end = (n // batch_size) * batch_size if drop_remainder else n
    for i in range(0, end, batch_size):
        yield idx[i : i + batch_size]


def num_batches(n: int, batch_size: int, drop_remainder: bool = False) -> int:
    return n // batch_size if drop_remainder else -(-n // batch_size)
