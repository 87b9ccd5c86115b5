"""The operations and bytes of a configuration's work, and the card's peaks:
the yardstick of the per-layer roofline and utilisation metrics.

The counts themselves are the configuration's model family's
(``step_flops`` and ``bounds`` in ``benchmark/reference/<reference>.py``),
counted from the configuration file's shapes, never from the program, so a
later implementation of the same work is held to the same count.  A
kernel's bound (``bound_s``) is the larger of its bytes over the memory
rate and its operations over the float32 rate: each input byte read once
and each output byte written once.
"""

from __future__ import annotations

from typing import Dict

from benchmark import plugins

# NVIDIA's data sheet for one H100 SXM, dense: bf16 tensor-core rate,
# float32 rate outside the tensor cores, HBM rate
PEAKS: Dict[str, Dict[str, float]] = {
    "H100": {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def peaks(device_name: str) -> Dict[str, float]:
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    raise KeyError(f"no peaks for {device_name!r}")


def bound_s(nbytes: float, flops: float, peak: Dict[str, float]) -> float:
    return max(nbytes / peak["hbm_bytes"], flops / peak["f32_flops"])


def step_flops(cfg: dict, b: int, kind: str) -> float:
    """Flops of one training step (``train``: forward, loss, backward) or
    one served batch (``serve``) of ``b`` samples."""
    return plugins.family(cfg).step_flops(cfg, b, kind)


def bounds(cfg: dict, b: int, kind: str, peak: Dict[str, float]) -> Dict[str, float]:
    """Seconds a step (``train``) or a served batch (``serve``) of ``b``
    samples needs at the bound, by the kernel each key names (uno2d:
    ``contract_s``, ``head_s``)."""
    return plugins.family(cfg).bounds(cfg, b, kind, peak)
