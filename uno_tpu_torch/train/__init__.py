"""The trainers (port of ``uno_tpu/train``).  ``uno_tpu``'s ``TrainState``
and ``apply_updates`` (JAX pytree plumbing, ``train/state.py``) are not
ported: the trainers keep their state in the model, the optimizer and a
dict (``train/checkpoint.py``)."""

from uno_tpu_torch.train.checkpoint import CheckpointManager
from uno_tpu_torch.train.common import BestTracker, TrainConfig, make_optimizer
from uno_tpu_torch.train.darcy import train_darcy
from uno_tpu_torch.train.evaluate import (
    evaluate_darcy,
    evaluate_ns2d,
    evaluate_ns3d,
    evaluate_superres,
)
from uno_tpu_torch.train.metrics import MetricLogger
from uno_tpu_torch.train.ns2d import make_rollout, train_ns2d
from uno_tpu_torch.train.ns3d import train_ns3d

__all__ = [
    "CheckpointManager",
    "BestTracker",
    "TrainConfig",
    "make_optimizer",
    "train_darcy",
    "evaluate_darcy",
    "evaluate_ns2d",
    "evaluate_ns3d",
    "evaluate_superres",
    "MetricLogger",
    "make_rollout",
    "train_ns2d",
    "train_ns3d",
]
