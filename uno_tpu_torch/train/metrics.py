"""Structured metrics logging (port of ``uno_tpu/train/metrics.py``): every
record is one JSON line, with the wall-clock time ``t``, on a stream
(stdout by default); with ``tensorboard_dir``, every numeric field of a
record that has a ``step`` is also a TensorBoard scalar at that step
(``torch.utils.tensorboard``, imported only then).

``uno_tpu`` drops the writer silently when its import fails
(``uno_tpu/train/metrics.py:22-25``); here a missing ``tensorboard`` package
raises, because a logger that drops what it was asked to write hides the
fault.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, Optional


class MetricLogger:
    def __init__(self, stream=None, tensorboard_dir: Optional[str] = None):
        self.stream = stream or sys.stdout
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                raise ImportError(
                    f"MetricLogger(tensorboard_dir={tensorboard_dir!r}) needs the "
                    "'tensorboard' package, which is not installed") from e
            self._tb = SummaryWriter(tensorboard_dir)

    def log(self, record: Dict[str, Any]) -> None:
        record = {"t": round(time.time(), 3), **record}
        self.stream.write(json.dumps(record, default=float) + "\n")
        self.stream.flush()
        if self._tb is not None and "step" in record:
            for k, v in record.items():
                if isinstance(v, (int, float)) and k not in ("step", "t"):
                    self._tb.add_scalar(k, v, record["step"])
            self._tb.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
