"""Trainer configuration (port of part of ``uno_tpu/train/common.py``).

Only the fields that batch inference reads are carried so far; the
optimizer, schedule and checkpoint fields come with the trainer.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class TrainConfig:
    batch_size: int = 16
    seed: int = 0
