"""ComplexAdam's step (``uno_tpu_torch/optim.py``) over a table of
parameters: one launch of ``adam_kernel`` (``uno_tpu_torch/csrc/adam.cu``)
for the parameters of a group on the card, the plain sequence of torch ops
(``update_plain``, then ``p.add_``) for those on the CPU.

Replaces no TPU kernel: ``uno_tpu``'s ``complex_adam`` is an optax
transform that XLA fuses.  On the card the plain sequence is about twelve
launches a parameter, 329 a step for uno9, and the host, not the card, set
their pace; the kernel is one launch, bound by the bytes it moves (48 a
complex element, 0.117 ms for uno9 at 3.35 TB/s).  The source says how.

A step is a list of ``Slot``: a parameter, its gradient, its moments and its
1-based step count.  The kernel reads pointers, so a moment may also be a
view into a larger buffer at any offset.  ``pack`` turns the
slots of one device into launches: the f32 hyperparameters, then one
64-byte entry a tensor (five pointers, the element count, whether it is
complex, and its f32 step size and ``1 / sqrt(bc2)``), at most
``MAX_TENSORS`` entries a launch (the kernel's parameters hold 4 KB).

A CUDA tensor of another dtype than f32 or complex64, a moment that does
not match its parameter, and a tensor that is not contiguous raise.
"""

from __future__ import annotations

import struct
from typing import List, NamedTuple, Optional

import torch

from uno_tpu_torch.ops.kernels._build import check, device_limits, library

# kernel launches since the count was last set to 0
LAUNCHES = {"step": 0}
# the kernel's constants (csrc/adam.cu: MAX_TENSORS, CHUNK)
MAX_TENSORS, CHUNK = 40, 4096
BLOCKS_PER_SM = 4  # the most blocks a launch asks for: 4 per SM
# csrc/adam.cu: Hyper (b1, 1 - b1, b2, 1 - b2, eps, weight decay, amsgrad,
# weight decay != 0) and Entry (p, g, mu, nu, max_nu, n, is_complex,
# step size, 1 / sqrt(bc2), padding)
HYPER = struct.Struct("<6f2i")
ENTRY = struct.Struct("<5Qqi2f4x")
_TYPES = (torch.float32, torch.complex64)


class Slot(NamedTuple):
    """One parameter's part of a step."""

    p: torch.Tensor
    g: torch.Tensor
    mu: torch.Tensor                # exp_avg, the parameter's dtype
    nu: torch.Tensor                # exp_avg_sq, real
    max_nu: Optional[torch.Tensor]  # max_exp_avg_sq under amsgrad, else None
    count: int                      # the 1-based step count of this parameter


class Launch(NamedTuple):
    """The arguments of one ``uno_adam_step`` call but the stream."""

    table: bytes  # HYPER, then `count` ENTRY
    count: int
    blocks: int   # min(chunks of the table's tensors, SMs x BLOCKS_PER_SM)


def step_size(group: dict, count: int) -> float:
    """``-lr / bc1`` at the 1-based step ``count``: the update's factor."""
    lr = group["lr"](count) if callable(group["lr"]) else group["lr"]
    return -lr / (1.0 - group["betas"][0] ** count)


def sqrt_bc2(group: dict, count: int) -> float:
    """``sqrt(1 - b2**count)``, which divides ``sqrt(nu)``."""
    return (1.0 - group["betas"][1] ** count) ** 0.5


def _abs2(g: torch.Tensor) -> torch.Tensor:
    """``re(g * conj(g))``: |g|^2, real, for real and complex g."""
    if g.is_complex():
        return torch.view_as_real(g).square().sum(dim=-1)
    return g * g


def update_plain(group: dict, count: int, g, p, mu, nu, max_nu=None) -> torch.Tensor:
    """Advance the moments ``mu``, ``nu`` (and ``max_nu``) by gradient ``g``
    of parameter ``p``; returns the update before its factor
    ``step_size``."""
    b1, b2 = group["betas"]
    if group["weight_decay"] != 0.0:
        g = g + group["weight_decay"] * p
    mu.mul_(b1).add_(g, alpha=1.0 - b1)
    nu.mul_(b2).add_(_abs2(g), alpha=1.0 - b2)
    if group["amsgrad"]:
        torch.maximum(max_nu, nu, out=max_nu)
        nu = max_nu
    denom = nu.sqrt().div_(sqrt_bc2(group, count)).add_(group["eps"])
    return mu / denom


def adam_plain(group: dict, slots: List[Slot]) -> None:
    """The step as torch ops, a parameter at a time: the kernel's reference."""
    for s in slots:
        s.p.add_(update_plain(group, s.count, s.g, s.p, s.mu, s.nu, s.max_nu),
                 alpha=step_size(group, s.count))


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest gap between f32 or complex64 tensors ``a`` and ``b`` in
    f32 units in the last place: how far the kernel lands from
    ``adam_plain``."""
    def key(t):
        t = torch.view_as_real(t) if t.is_complex() else t
        i = t.detach().contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((key(a) - key(b)).abs().max()) if a.numel() else 0


def _check(i: int, name: str, t, dtype, n: int, device: int) -> None:
    """Raise unless ``t``, the ``name`` of parameter ``i``, is a contiguous
    ``dtype`` tensor of ``n`` elements on ``device`` (``get_device()``)."""
    if t is None or t.dtype != dtype or t.numel() != n or t.get_device() != device:
        got = None if t is None else f"{t.dtype} {tuple(t.shape)} on {t.device}"
        raise ValueError(f"ComplexAdam: the {name} of parameter {i} is {got}, where the step "
                         f"takes {dtype} of {n} elements on its parameter's device")
    if not t.is_contiguous():
        raise ValueError(f"ComplexAdam: the {name} of parameter {i} ({dtype} "
                         f"{tuple(t.shape)}) is not contiguous")


def pack(group: dict, slots: List[Slot], sms: int) -> List[Launch]:
    """The launches of one step over ``slots``, all on one device with
    ``sms`` SMs: ``MAX_TENSORS`` tensors a launch, in order.  Empty
    parameters are left out."""
    b1, b2 = group["betas"]
    wd, amsgrad = group["weight_decay"], bool(group["amsgrad"])
    hyper = HYPER.pack(b1, 1.0 - b1, b2, 1.0 - b2, group["eps"], wd, amsgrad, wd != 0.0)
    device = slots[0].p.get_device() if slots else -1
    factors, entries, chunks = {}, [], []
    for i, s in enumerate(slots):
        dtype, n = s.p.dtype, s.p.numel()
        if dtype not in _TYPES:
            raise TypeError(f"ComplexAdam: parameter {i} is {dtype} on {s.p.device}; the "
                            f"kernel takes float32 and complex64")
        _check(i, "parameter", s.p, dtype, n, device)
        _check(i, "gradient", s.g, dtype, n, device)
        _check(i, "exp_avg", s.mu, dtype, n, device)
        _check(i, "exp_avg_sq", s.nu, torch.float32, n, device)
        if amsgrad:
            _check(i, "max_exp_avg_sq", s.max_nu, torch.float32, n, device)
        if n == 0:
            continue
        if s.count not in factors:  # each rounded once to f32: torch's CUDA `div_` by a
            # number multiplies by its reciprocal, taken in double
            factors[s.count] = step_size(group, s.count), 1.0 / sqrt_bc2(group, s.count)
        entries.append(ENTRY.pack(s.p.data_ptr(), s.g.data_ptr(), s.mu.data_ptr(),
                                  s.nu.data_ptr(), s.max_nu.data_ptr() if amsgrad else 0,
                                  n, dtype is torch.complex64, *factors[s.count]))
        chunks.append(-(-n // CHUNK))
    return [Launch(hyper + b"".join(entries[lo:lo + MAX_TENSORS]),
                   len(entries[lo:lo + MAX_TENSORS]),
                   min(sum(chunks[lo:lo + MAX_TENSORS]), sms * BLOCKS_PER_SM))
            for lo in range(0, len(entries), MAX_TENSORS)]


def launch(launches: List[Launch], device: torch.device) -> None:
    """Run ``pack``'s launches on ``device``'s current stream."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for ln in launches:
            check(library().uno_adam_step(ln.table, ln.count, ln.blocks, stream),
                  "uno_adam_step")
            LAUNCHES["step"] += 1


def adam_step(group: dict, slots: List[Slot]) -> None:
    """One step of ``group`` over ``slots``: the kernel where the first
    parameter lies on the card (``pack`` refuses a parameter on another
    device), the plain sequence where it lies on the CPU."""
    device = slots[0].p.device
    if device.type == "cuda":
        launch(pack(group, slots, device_limits(device.index)[0]), device)
    elif device.type == "cpu":
        adam_plain(group, slots)
    else:
        raise ValueError(f"ComplexAdam runs on cpu or cuda, not {device}")
