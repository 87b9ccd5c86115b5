"""MATLAB .mat IO (a copy of ``uno_tpu/data/mat.py``, which imports no JAX).

Equivalent of the reference ``MatReader`` (utilities3.py:21-72), torch-free:
scipy for v5 files, h5py fallback for v7.3 with the axis-reversing transpose
(the reference's h5py import is commented out — utilities3.py:5 — making the
v7.3 path a latent NameError; fixed here with a lazy import).
tests/test_torch_guards.py holds this copy equal to the original.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import scipy.io


class MatReader:
    def __init__(self, file_path: str, to_float: bool = True):
        self.to_float = to_float
        self.file_path = file_path
        self._h5 = False
        self._load(file_path)

    def _load(self, path: str) -> None:
        try:
            self.data: Any = scipy.io.loadmat(path)
            self._h5 = False
        except Exception:
            import h5py  # lazy: only needed for v7.3 files

            self.data = h5py.File(path, "r")
            self._h5 = True

    def load_file(self, file_path: str) -> None:
        self.file_path = file_path
        self._load(file_path)

    def read_field(self, field: str) -> np.ndarray:
        x = self.data[field]
        if self._h5:
            x = x[()]
            x = np.transpose(x, axes=range(len(x.shape) - 1, -1, -1))
        if self.to_float:
            x = x.astype(np.float32)
        return np.asarray(x)
