"""The Navier–Stokes dataset builder (port of ``load_navier_stokes`` in
``uno_tpu/data/loaders.py``).

Behavioral equivalent of ``load_NS_`` (data_load_navier_stocks.py:24-72):
the generator's batched ``u{i}`` fields are read in order, the first
``t_in`` frames become inputs and the next ``t_out`` targets, each resized
to ``size`` by bilinear ``align_corners=True`` interpolation as separable
matmuls with the port's copy of ``uno_tpu``'s resample tables.  numpy
throughout, as in ``uno_tpu``.  The Darcy loaders are not ported yet
(ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from uno_tpu_torch.data.mat import MatReader
from uno_tpu_torch.ops.resample import resize_matrix


def _bilinear_resize_hw(x: np.ndarray, size: int) -> np.ndarray:
    """(N, H, W, T) -> (N, size, size, T), bilinear align_corners=True."""
    h, w = x.shape[1], x.shape[2]
    if h == size and w == size:
        return x
    mh = resize_matrix(h, size, "linear", True, False)
    mw = resize_matrix(w, size, "linear", True, False)
    x = np.einsum("oh,nhwt->nowt", mh, x)
    return np.einsum("ow,nhwt->nhot", mw, x)


def load_navier_stokes(
    path: str,
    train: int,
    test: int,
    sample_num: int = 1000,
    batch: int = 20,
    t_in: int = 10,
    t_out: int = 10,
    size: int = 64,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Iterate the generator's batched ``u{i}`` fields; ``batch`` must equal
    the generation batch size (data_load_navier_stocks.py:28)."""
    reader = MatReader(path)
    train_a, train_u, test_a, test_u = [], [], [], []
    idx = 0
    for i in range(sample_num // batch):
        idx += batch
        u = reader.read_field(f"u{i}")
        k_a = _bilinear_resize_hw(u[..., :t_in], size)
        k_u = _bilinear_resize_hw(u[..., t_in : t_in + t_out], size)
        if idx <= train:
            train_a.append(k_a)
            train_u.append(k_u)
        else:
            test_a.append(k_a)
            test_u.append(k_u)
    return (
        np.concatenate(train_a),
        np.concatenate(train_u),
        np.concatenate(test_a) if test_a else np.empty((0,)),
        np.concatenate(test_u) if test_u else np.empty((0,)),
    )
