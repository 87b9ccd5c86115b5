"""The Darcy and Navier–Stokes dataset loaders (port of
``uno_tpu/data/loaders.py``; tests/test_torch_guards.py holds each function
equal to its original).

* ``load_darcy`` — ``load_data_darcy`` (data_load_darcy.py:22-41): the
  ``coeff``/``sol`` fields of a ``.mat`` file subsampled ``::r`` from the
  421-point grid and trimmed to s = (421 - 1) / r + 1, the first ``ntrain``
  samples for training and the last ``ntest`` for testing.
* ``load_darcy_multi`` — the reference's multi-file recipe
  (darcy_flow_main.py:37-93): a 4:1 train/test block from each file, pooled,
  permuted by a seeded ``default_rng`` and split three ways.
* ``load_navier_stokes`` — ``load_NS_`` (data_load_navier_stocks.py:24-72):
  the generator's batched ``u{i}`` fields are read in order, the first
  ``t_in`` frames become inputs and the next ``t_out`` targets, each resized
  to ``size`` by bilinear ``align_corners=True`` interpolation as separable
  matmuls with the port's copy of ``uno_tpu``'s resample tables.

numpy throughout, as in ``uno_tpu``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from uno_tpu_torch.data.mat import MatReader
from uno_tpu_torch.ops.resample import resize_matrix


def load_darcy(
    r: int, ntrain: int, ntest: int, path: str, grid_full: int = 421
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Subsample ``::r`` from the full grid; first-n train / last-n test split.

    Returns x_train (ntrain, s, s, 1), y_train (ntrain, s, s),
            x_test  (ntest, s, s, 1),  y_test  (ntest, s, s).
    """
    s = int((grid_full - 1) / r) + 1
    reader = MatReader(path)
    coeff = reader.read_field("coeff")
    sol = reader.read_field("sol")
    x_train = coeff[:ntrain, ::r, ::r][:, :s, :s]
    y_train = sol[:ntrain, ::r, ::r][:, :s, :s]
    x_test = coeff[-ntest:, ::r, ::r][:, :s, :s]
    y_test = sol[-ntest:, ::r, ::r][:, :s, :s]
    return (
        x_train.reshape(ntrain, s, s, 1),
        y_train,
        x_test.reshape(ntest, s, s, 1),
        y_test,
    )


def load_darcy_multi(
    paths,
    ntrain: int,
    nval: int,
    ntest: int,
    sub: int = 2,
    per_file_train: int = None,
    per_file_test: int = None,
    seed: int = 0,
    grid_full: int = 421,
) -> Tuple[np.ndarray, ...]:
    """Reference multi-file Darcy recipe (darcy_flow_main.py:37-93): load
    ``per_file_train + per_file_test`` samples from each file (train block
    first, test block from the end), concatenate all train blocks then all
    test blocks, shuffle the pooled indices, split ntrain/nval/ntest.

    ``per_file_train/test`` default to the reference's 4:1 ratio (800/200)
    scaled to each file's actual sample count.  The reference shuffles with
    ``random.shuffle`` (unseeded); here the permutation is a seeded
    ``default_rng`` so splits are reproducible.

    Returns (train_a, train_u, val_a, val_u, test_a, test_u) with ``a`` of
    shape (n, s, s, 1) and ``u`` of (n, s, s).
    """
    tr_a, tr_u, te_a, te_u = [], [], [], []
    for p in paths:
        if per_file_train is None or per_file_test is None:
            n_file = MatReader(p).read_field("coeff").shape[0]
            n_tr = (
                per_file_train
                if per_file_train is not None
                else n_file * 4 // 5
            )
            n_te = (
                per_file_test
                if per_file_test is not None
                else n_file - n_file * 4 // 5
            )
        else:
            n_tr, n_te = per_file_train, per_file_test
        xa, ya, xb, yb = load_darcy(sub, n_tr, n_te, p, grid_full=grid_full)
        tr_a.append(xa)
        tr_u.append(ya)
        te_a.append(xb)
        te_u.append(yb)
    a = np.concatenate(tr_a + te_a)
    u = np.concatenate(tr_u + te_u)
    n = a.shape[0]
    if ntrain + nval + ntest > n:
        raise ValueError(
            f"split {ntrain}+{nval}+{ntest} exceeds pooled samples {n}"
        )
    idx = np.random.default_rng(seed).permutation(n)
    i1, i2, i3 = ntrain, ntrain + nval, ntrain + nval + ntest
    return (
        a[idx[:i1]],
        u[idx[:i1]],
        a[idx[i1:i2]],
        u[idx[i1:i2]],
        a[idx[i2:i3]],
        u[idx[i2:i3]],
    )


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
