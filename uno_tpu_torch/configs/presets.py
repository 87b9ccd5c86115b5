"""Named experiment presets: the Darcy, NS-2D and NS-3D presets of
``uno_tpu/configs/presets.py``.

* ``darcy_s211``  — darcy_flow_main.py:37-117 (S=211 via sub=2, 1500/250/250,
  width 32, 700 epochs, lr 1e-3, wd 1e-3, StepLR(100, 0.5), UNO_9 pad=12)
* ``darcy_s85``   — the CPU-scale variant (sub=5)
* ``darcy_s421``  — full resolution with the deeper UNO_11 stack
* ``ns2d``        — ns_uno2d_main.py:26-107 (S=64, T_in=10, T_f=40 rollout)
* ``ns2d_s256``   — UNO_S256 at 256²
* ``ns3d_t40`` / ``t20`` / ``t10`` / ``t9`` — ns_uno3d_main.py (S=64,
  T_in=10 (6 for t9) -> T_f=40/20/10/9 in one forward, 9000/1000/1000,
  width 8, lr 3e-3)

tests/test_torch_guards.py holds every field here equal to ``uno_tpu``'s.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
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
    t_in: int = 10                 # NS: input frames
    t_f: int = 10                  # NS: frames predicted
    size: int = 64                 # NS: grid


def _darcy_train(batch_size: int) -> TrainConfig:
    return TrainConfig(
        epochs=700, batch_size=batch_size, learning_rate=1e-3,
        scheduler_step=100, scheduler_gamma=0.5, weight_decay=1e-3,
        seed=10001,
    )


def _ns2d_train(batch_size: int) -> TrainConfig:
    return TrainConfig(
        epochs=500, batch_size=batch_size, learning_rate=1e-3,
        scheduler_step=100, scheduler_gamma=0.5, weight_decay=1e-5,
        eval_every=2,
    )


def _ns3d(name: str, model: str, t_f: int, t_in: int) -> Preset:
    return Preset(
        name=name, task="ns3d", model=model,
        model_kwargs=dict(in_width=6, width=8, pad=3 if name == "ns3d_t40" else 2),
        train=TrainConfig(
            epochs=500, batch_size=16, learning_rate=3e-3,
            scheduler_step=100, scheduler_gamma=0.5, weight_decay=1e-5,
            eval_every=2,
        ),
        ntrain=9000, nval=1000, ntest=1000, t_in=t_in, t_f=t_f, size=64,
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
        Preset(
            name="ns2d", task="ns2d", model="uno",
            model_kwargs=dict(in_width=14, width=32, pad=0),
            train=_ns2d_train(batch_size=16),
            ntrain=4000, nval=500, ntest=500, t_in=10, t_f=40, size=64,
        ),
        Preset(
            name="ns2d_s256", task="ns2d", model="uno_s256",
            model_kwargs=dict(in_width=14, width=32, pad=0),
            train=_ns2d_train(batch_size=4),
            ntrain=4000, nval=500, ntest=500, t_in=10, t_f=40, size=256,
        ),
        _ns3d("ns3d_t40", "uno3d_t40", 40, 10),
        _ns3d("ns3d_t20", "uno3d_t20", 20, 10),
        _ns3d("ns3d_t10", "uno3d_t10", 10, 10),
        _ns3d("ns3d_t9", "uno3d_t9", 9, 6),
    )
}


def get_preset(name: str, **overrides) -> Preset:
    """The preset ``name``, with each override that names a ``TrainConfig``
    field replaced in its ``train`` and the others in the preset itself,
    as ``uno_tpu``'s ``get_preset`` does."""
    p = PRESETS[name]
    train_fields = {f.name for f in fields(TrainConfig)}
    train_over = {k: overrides.pop(k) for k in list(overrides) if k in train_fields}
    if train_over:
        p = replace(p, train=replace(p.train, **train_over))
    if overrides:
        p = replace(p, **overrides)
    return p
