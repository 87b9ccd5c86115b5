"""Structured metrics logging (port of ``uno_tpu/train/metrics.py``): every
record is one JSON line, with the wall-clock time ``t``, on a stream
(stdout by default).  There is no TensorBoard writer."""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict


class MetricLogger:
    def __init__(self, stream=None):
        self.stream = stream or sys.stdout

    def log(self, record: Dict[str, Any]) -> None:
        record = {"t": round(time.time(), 3), **record}
        self.stream.write(json.dumps(record, default=float) + "\n")
        self.stream.flush()
