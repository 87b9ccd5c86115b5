"""Named experiment presets: the Darcy presets of
``uno_tpu/configs/presets.py``.

* ``darcy_s211``  — darcy_flow_main.py:37-117 (S=211 via sub=2, 1500/250/250,
  width 32, 700 epochs, lr 1e-3, wd 1e-3, StepLR(100, 0.5), UNO_9 pad=12)
* ``darcy_s85``   — the CPU-scale variant (sub=5)
* ``darcy_s421``  — full resolution with the deeper UNO_11 stack

tests/test_torch_guards.py holds every field here equal to ``uno_tpu``'s.
The NS presets come with the NS-2D and NS-3D models.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

from uno_tpu_torch.train.common import TrainConfig


@dataclass
class Preset:
    name: str
    task: str                      # 'darcy' | 'ns2d' | 'ns3d'
    model: str
    model_kwargs: Dict[str, Any]
    train: TrainConfig
    # data parameters
    sub: int = 1                   # darcy subsampling
    ntrain: int = 0
    nval: int = 0
    ntest: int = 0


def _darcy_train(batch_size: int) -> TrainConfig:
    return TrainConfig(
        epochs=700, batch_size=batch_size, learning_rate=1e-3,
        scheduler_step=100, scheduler_gamma=0.5, weight_decay=1e-3,
        seed=10001,
    )


PRESETS: Dict[str, Preset] = {
    p.name: p
    for p in (
        Preset(
            name="darcy_s211", task="darcy", model="uno9",
            model_kwargs=dict(in_width=3, width=32, pad=12),
            train=_darcy_train(batch_size=16),
            sub=2, ntrain=1500, nval=250, ntest=250,
        ),
        Preset(
            name="darcy_s85", task="darcy", model="uno9",
            model_kwargs=dict(in_width=3, width=32, pad=5),
            train=_darcy_train(batch_size=16),
            sub=5, ntrain=1000, nval=100, ntest=100,
        ),
        Preset(
            name="darcy_s421", task="darcy", model="uno11",
            model_kwargs=dict(in_width=3, width=32, pad=12),
            train=_darcy_train(batch_size=4),
            sub=1, ntrain=1500, nval=250, ntest=250,
        ),
    )
}


def get_preset(name: str) -> Preset:
    return PRESETS[name]
