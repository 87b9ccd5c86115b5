"""The host side of ComplexAdam's CUDA step (``uno_tpu_torch/ops/kernels/adam.py``):
the table ``pack`` hands ``uno_adam_step``, its split over launches, each
tensor's f32 factors, the checks that refuse what the kernel cannot take,
and the entry point's ctypes signature.  The kernel itself runs only on the
card (``tests/test_torch_cuda.py``); here CPU tensors stand in for its
pointers, which ``pack`` reads the same way."""

import ctypes

import numpy as np
import pytest
import torch

from uno_tpu_torch.ops.kernels import _build
from uno_tpu_torch.ops.kernels import adam as A
from uno_tpu_torch.optim import ComplexAdam, step_lr

SMS = 132


def _group(amsgrad=False, wd=1e-3, lr=1e-3):
    return dict(lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd, amsgrad=amsgrad)


def _slots(shapes, amsgrad=False, count=1):
    """A slot of fresh tensors a (shape, dtype)."""
    out = []
    for shape, dtype in shapes:
        p = torch.zeros(shape, dtype=dtype)
        nu = torch.zeros(shape)
        out.append(A.Slot(p, torch.zeros_like(p), torch.zeros_like(p), nu,
                          torch.zeros_like(nu) if amsgrad else None, count))
    return out


def _entries(launch):
    return list(A.ENTRY.iter_unpack(launch.table[A.HYPER.size:]))


_F, _C = torch.float32, torch.complex64
# uno9's 27 parameters at darcy_s211 (width 32): 22 f32, 5 complex64 spectral weights
UNO9 = [((16, 3), _F), ((16,), _F), ((32, 16), _F), ((32,), _F), ((2, 32, 64, 18, 18), _C),
        ((64, 32), _F), ((64,), _F), ((128,), _F), ((128,), _F), ((2, 64, 128, 8, 8), _C),
        ((128, 64), _F), ((128,), _F), ((2, 128, 128, 8, 8), _C), ((128, 128), _F),
        ((128,), _F), ((64,), _F), ((64,), _F), ((2, 128, 64, 8, 8), _C), ((64, 128), _F),
        ((64,), _F), ((2, 128, 32, 18, 18), _C), ((32, 128), _F), ((32,), _F), ((32, 64), _F),
        ((32,), _F), ((1, 32), _F), ((1,), _F)]


@pytest.mark.parametrize("shapes,amsgrad,want", [
    (UNO9, False, [27]),
    (UNO9, True, [27]),
    ([((3,), _F)] * 41, False, [40, 1]),
    ([((5, 2), _C), ((7,), _F)] * 50, True, [40, 40, 20]),
    ([((0, 4), _F), ((9,), _C), ((0,), _C)], False, [1]),
])
def test_pack_splits_the_table_over_launches(shapes, amsgrad, want):
    slots = _slots(shapes, amsgrad)
    launches = A.pack(_group(amsgrad), slots, SMS)
    assert [ln.count for ln in launches] == want
    kept = [s for s in slots if s.p.numel()]  # empty tensors are left out
    got = [e for ln in launches for e in _entries(ln)]
    assert len(got) == len(kept)
    for s, (p, g, mu, nu, mx, n, cplx, _, _) in zip(kept, got):
        assert (p, g, mu, nu) == (s.p.data_ptr(), s.g.data_ptr(), s.mu.data_ptr(),
                                  s.nu.data_ptr())
        assert mx == (s.max_nu.data_ptr() if amsgrad else 0)
        assert n == s.p.numel() and cplx == int(s.p.is_complex())
    for lo, ln in zip(range(0, len(kept), A.MAX_TENSORS), launches):
        chunks = sum(-(-s.p.numel() // A.CHUNK) for s in kept[lo:lo + A.MAX_TENSORS])
        assert ln.blocks == min(chunks, SMS * A.BLOCKS_PER_SM)
        assert len(ln.table) == A.HYPER.size + ln.count * A.ENTRY.size


def test_pack_spreads_uno9_over_the_card():
    """uno9's 8,218,049 numbers fall in 2,023 chunks, more than the card
    holds blocks at once: the grid is as large as that."""
    (ln,) = A.pack(_group(), _slots(UNO9), SMS)
    assert sum(e[5] for e in _entries(ln)) == 8_175_616 + 42_433
    assert sum(-(-e[5] // A.CHUNK) for e in _entries(ln)) == 2_023
    assert ln.blocks == SMS * A.BLOCKS_PER_SM


@pytest.mark.parametrize("amsgrad,wd", [(False, 0.0), (True, 1e-3)])
def test_hyperparameters_are_rounded_as_torch_rounds_them(amsgrad, wd):
    (ln,) = A.pack(_group(amsgrad, wd), _slots(UNO9[:2], amsgrad), SMS)
    b1, a1, b2, a2, eps, w, ams, has_wd = A.HYPER.unpack(ln.table[:A.HYPER.size])
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    assert (b1, a1, b2, a2, eps, w) == (f32(0.9), f32(1.0 - 0.9), f32(0.999), f32(1.0 - 0.999),
                                        f32(1e-8), f32(wd))
    assert (ams, has_wd) == (int(amsgrad), int(wd != 0.0))


def test_each_tensor_takes_its_own_factors_across_an_epoch_boundary():
    """Step counts that differ by parameter (gradients left out on some
    steps) under StepLR with 2 steps an epoch: each entry's step size is
    ``step_size``'s and its ``1 / sqrt(bc2)`` the reciprocal, rounded to f32,
    of the root ``update_plain`` divides by."""
    sched = step_lr(1e-3, 1, 0.5, steps_per_epoch=2)
    ps = [torch.nn.Parameter(torch.zeros(4)), torch.nn.Parameter(torch.zeros(3, dtype=_C)),
          torch.nn.Parameter(torch.zeros(2))]
    opt = ComplexAdam(ps, lr=sched, weight_decay=1e-3, amsgrad=True)
    for k in range(7):
        for i, p in enumerate(ps):
            p.grad = torch.ones_like(p) if k % (i + 1) == 0 else None
        opt.step()
    for p in ps:
        p.grad = torch.ones_like(p)
    group = opt.param_groups[0]
    _, slots = opt._slots(group)
    counts = [s.count for s in slots]
    assert counts == [8, 5, 4]  # steps 1-7, then this one
    assert len({sched(c) for c in counts}) == 3  # three epochs' rates
    (ln,) = A.pack(group, slots, SMS)
    for c, e in zip(counts, _entries(ln)):
        step, inv = e[7], e[8]
        assert step == float(np.float32(A.step_size(group, c)))
        assert step == float(np.float32(-sched(c) / (1.0 - 0.9**c)))
        assert inv == float(np.float32(1.0 / (1.0 - 0.999**c) ** 0.5))
        assert A.sqrt_bc2(group, c) == (1.0 - 0.999**c) ** 0.5


def test_pack_refuses_what_the_kernel_cannot_take():
    group = _group(amsgrad=True)
    (ok,) = _slots([((4, 3), _F)], amsgrad=True)
    with pytest.raises(TypeError, match="float64"):
        A.pack(group, _slots([((2,), torch.float64)], amsgrad=True), SMS)
    with pytest.raises(ValueError, match="gradient of parameter 0 .* not contiguous"):
        A.pack(group, [ok._replace(g=torch.zeros(3, 4).t())], SMS)
    with pytest.raises(ValueError, match="exp_avg_sq of parameter 0"):
        A.pack(group, [ok._replace(nu=torch.zeros(4, 3, dtype=torch.float64))], SMS)
    with pytest.raises(ValueError, match="max_exp_avg_sq of parameter 0 is None"):
        A.pack(group, [ok._replace(max_nu=None)], SMS)
    with pytest.raises(ValueError, match="exp_avg of parameter 0"):
        A.pack(group, [ok._replace(mu=torch.zeros(5))], SMS)


def test_a_refused_step_leaves_the_step_counts(monkeypatch):
    """A step that ``adam_step`` refuses (on the card: a float64 parameter,
    a gradient that is not contiguous) advances no count, so a caller that
    catches the error steps on with the right bias corrections."""
    ps = [torch.nn.Parameter(torch.ones(4)), torch.nn.Parameter(torch.ones(3, dtype=_C))]
    opt = ComplexAdam(ps, lr=1e-2)
    for p in ps:
        p.grad = torch.ones_like(p)
    opt.step()

    def refuse(group, slots):
        raise ValueError("refused")

    with monkeypatch.context() as m:
        m.setattr(A, "adam_step", refuse)
        with pytest.raises(ValueError, match="refused"):
            opt.step()
    assert [opt.state[p]["step"] for p in ps] == [1, 1]
    seen = []
    with monkeypatch.context() as m:
        m.setattr(A, "adam_step", lambda group, slots: seen.extend(s.count for s in slots))
        opt.step()
    assert seen == [2, 2]


def test_the_cpu_step_never_reaches_the_kernel():
    before = dict(A.LAUNCHES)
    p = torch.nn.Parameter(torch.ones(3, dtype=torch.complex64))
    opt = ComplexAdam([p], lr=1e-2)
    p.grad = torch.ones_like(p)
    opt.step()
    assert A.LAUNCHES == before and not torch.equal(p.detach(), torch.ones_like(p))


def test_the_entry_point_takes_pointers_as_void_pointers():
    assert _build._SIGNATURES["uno_adam_step"] == [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                                   ctypes.c_void_p]
