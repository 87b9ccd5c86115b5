"""Model summary (port of ``uno_tpu/utils/summary.py``): the
``torchsummary.summary`` counterpart the reference's drivers print as a
shape check (darcy_flow_main.py:97), over the module's
``named_parameters()``.  A complex weight counts once per element, as its
JAX leaf does, so the counts equal ``uno_tpu``'s for the same model."""

from __future__ import annotations

from torch import nn


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def param_bytes(model: nn.Module) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def summarize(model: nn.Module) -> str:
    """One line per parameter (name, shape, dtype, count) and the total."""
    lines = []
    for name, p in model.named_parameters():
        lines.append(f"{name:70s} {str(tuple(p.shape)):24s} {str(p.dtype):16s} "
                     f"{p.numel():>12,}")
    lines.append("-" * 126)
    lines.append(f"{'total parameters':70s} {'':24s} {'':16s} {count_params(model):>12,}")
    return "\n".join(lines)
