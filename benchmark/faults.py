"""Faults planted in the program, to show that ``correct`` comes out false
when the timed path is broken: used by the harness's tests on the CPU and
by ``run.py --calibrate --mode fault:<name>`` on the chip.

* ``unchanged``: the optimizer's step returns the state as it was.
* ``half_batch``: the loss is taken over the first half of the batch alone,
  its mean over those rows standing for the whole batch's.
* ``no_exchange``: the sum of the loss and gradients over the ranks is left
  out, so each rank steps on its own rows.
* ``altered_answer``: the model's output for the first sample of a batch is
  negated where it is produced.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patch(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _unchanged():
    from uno_tpu_torch.optim import ComplexAdam

    return _patch(ComplexAdam, "step", lambda self, closure=None: None)


def _half_batch():
    from uno_tpu_torch import losses

    whole = losses.relative_lp_loss

    def half(x, y, p=2, reduction="sum", group=None):
        h = x.shape[0] // 2
        return whole(x[:h], y[:h], p, reduction, group) * (x.shape[0] / h)

    return _patch(losses, "relative_lp_loss", half)


def _no_exchange():
    from uno_tpu_torch.parallel import shmap

    return _patch(shmap, "_sum_over", lambda group, tensors: None)


def _altered_answer():
    from uno_tpu_torch.models.core import UNOModel

    forward = UNOModel.forward

    def altered(self, x, split=None):
        out = forward(self, x, split)
        return torch.cat([-out[:1], out[1:]])

    return _patch(UNOModel, "forward", altered)


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "no_exchange": _no_exchange,
          "altered_answer": _altered_answer}


def planted(mode: str):
    """The fault a ``fault:<name>`` mode names, planted for the block."""
    if not mode.startswith("fault:"):
        return contextlib.nullcontext()
    return FAULTS[mode.split(":", 1)[1]]()
