"""3D spatiotemporal U-NO family (Navier-Stokes 2D+time): a framework-free
copy of ``uno_tpu/models/uno3d.py`` (tests/test_torch_guards.py holds every
factory's spec equal to the original's).

Space contracts through the encoder while the **time axis expands** through
the decoder (navier_stokes_uno3d.py:125-159).  Input (B, S, S, T, 1) ->
output (B, S, S, k*T, 1) with k ∈ {4, 2, 1, 3/2}.

Factories (reference classes in navier_stokes_uno3d.py):
* ``uno3d_t40`` / ``t20`` / ``t10`` / ``t9``       (:22-212, :218-409, :412-602, :605-795)
* ``uno3d_t40_256`` / ``t20_256`` / ``t10_256`` / ``t9_256``  (:804-1563)

As in ``uno_tpu``, the reference's ``Uno3D_T40_256`` bugs (``fc_n1``
defined but ``fc`` called, an unset ``pad_both``) are fixed: the lift is
``fc`` and ``pad_both`` defaults False.
"""

from __future__ import annotations

from fractions import Fraction as F

from uno_tpu_torch.models.core import LIFT, BlockSpec, UNOSpec

_1 = F(1)
_12 = F(1, 2)
_14 = F(1, 4)
_18 = F(1, 8)
_34 = F(3, 4)
_116 = F(1, 16)
_132 = F(1, 32)


def _b(ch, gx, gy, gt, mx, my, mt, norm=False, skip=None):
    return BlockSpec(
        channels=int(ch),
        grid=(gx, gy, gt),
        modes=(mx, my, mt),
        normalize=norm,
        skip=skip,
    )


def _spec3d(name, in_width, width, pad, pad_both, lift_hidden, blocks, crop_mult):
    return UNOSpec(
        name=name,
        ndim=3,
        in_width=in_width,
        width=width,
        lift_hidden=lift_hidden,
        embed="sincos3d",
        pad=pad,
        pad_mode="time",
        blocks=blocks,
        proj_hidden=4 * width,
        pad_both=pad_both,
        crop_mult=crop_mult,
    )


def uno3d_t40(in_width=6, width=8, pad=2, factor=1, pad_both=False) -> UNOSpec:
    w, f = width, factor
    return _spec3d(
        "uno3d_t40", in_width, w, pad, pad_both, w // 2,
        (
            _b(2 * f * w, _34, _34, _1, 20, 20, 4, norm=True),
            _b(4 * f * w, _12, _12, _1, 14, 14, 4),
            _b(8 * f * w, _14, _14, F(8, 5), 6, 6, 4),
            _b(16 * f * w, _18, _18, F(8, 5), 6, 6, 7, norm=True),
            _b(4 * f * w, _12, _12, F(12, 5), 6, 6, 7, skip=1),
            _b(2 * f * w, _34, _34, F(16, 5), 14, 14, 10, norm=True, skip=0),
            _b(2 * w, _1, _1, F(4), 20, 20, 14, skip=LIFT),
        ),
        crop_mult=F(4),
    )


def uno3d_t20(in_width=6, width=8, pad=2, factor=1, pad_both=False) -> UNOSpec:
    w, f = width, factor
    return _spec3d(
        "uno3d_t20", in_width, w, pad, pad_both, in_width * 2,
        (
            _b(2 * f * w, _34, _34, _1, 22, 22, 5, norm=True),
            _b(4 * f * w, _12, _12, _1, 14, 14, 5),
            _b(8 * f * w, _14, _14, F(6, 5), 6, 6, 5),
            _b(16 * f * w, _14, _14, F(6, 5), 6, 6, 6, norm=True),
            _b(4 * f * w, _12, _12, F(9, 5), 6, 6, 6, skip=1),
            _b(2 * f * w, _34, _34, F(2), 14, 14, 8, norm=True, skip=0),
            _b(2 * w, _1, _1, F(2), 22, 22, 8, skip=LIFT),
        ),
        crop_mult=F(2),
    )


def uno3d_t10(in_width=6, width=8, pad=2, factor=1, pad_both=False) -> UNOSpec:
    w, f = width, factor
    return _spec3d(
        "uno3d_t10", in_width, w, pad, pad_both, in_width * 2,
        (
            _b(2 * f * w, _34, _34, _1, 22, 22, 5, norm=True),
            _b(4 * f * w, _12, _12, _1, 14, 14, 5),
            _b(8 * f * w, _14, _14, _1, 6, 6, 5),
            _b(16 * f * w, _14, _14, _1, 6, 6, 5, norm=True),
            _b(4 * f * w, _12, _12, _1, 6, 6, 5, skip=1),
            _b(2 * f * w, _34, _34, _1, 14, 14, 5, norm=True, skip=0),
            _b(2 * w, _1, _1, _1, 22, 22, 5, skip=LIFT),
        ),
        crop_mult=F(1),
    )


def uno3d_t9(in_width=6, width=8, pad=2, factor=1, pad_both=False) -> UNOSpec:
    w, f = width, factor
    return _spec3d(
        "uno3d_t9", in_width, w, pad, pad_both, in_width * 2,
        (
            _b(2 * f * w, _34, _34, _1, 20, 20, 3, norm=True),
            _b(4 * f * w, _12, _12, _1, 18, 18, 3),
            _b(8 * f * w, _14, _14, _1, 6, 6, 3),
            _b(16 * f * w, _14, _14, F(4, 3), 6, 6, 3, norm=True),
            _b(4 * f * w, _12, _12, F(4, 3), 6, 6, 3, skip=1),
            _b(2 * f * w, _34, _34, F(3, 2), 14, 14, 3, norm=True, skip=0),
            _b(2 * w, _1, _1, F(3, 2), 20, 20, 4, skip=LIFT),
        ),
        crop_mult=F(3, 2),
    )


def uno3d_t40_256(in_width=6, width=8, pad=1, factor=1, pad_both=False) -> UNOSpec:
    w, f = width, factor
    return _spec3d(
        "uno3d_t40_256", in_width, w, pad, pad_both, w // 2,
        (
            _b(2 * f * w, _14, _14, _1, 32, 32, 5, norm=True),
            _b(4 * f * w, _116, _116, _1, 8, 8, 5),
            _b(8 * f * w, _132, _132, F(8, 5), 4, 4, 5),
            _b(16 * f * w, _132, _132, F(8, 5), 4, 4, 8, norm=True),
            _b(16 * f * w, _132, _132, F(8, 5), 4, 4, 8),
            _b(8 * f * w, _132, _132, F(8, 5), 4, 4, 8, norm=True),
            _b(4 * f * w, _116, _116, F(12, 5), 4, 4, 8, skip=1),
            _b(2 * f * w, _14, _14, F(16, 5), 8, 8, 12, norm=True, skip=0),
            _b(2 * w, _1, _1, F(4), 32, 32, 16, skip=LIFT),
        ),
        crop_mult=F(4),
    )


def uno3d_t20_256(in_width=6, width=8, pad=2, factor=1, pad_both=False) -> UNOSpec:
    w, f = width, factor
    return _spec3d(
        "uno3d_t20_256", in_width, w, pad, pad_both, w // 2,
        (
            _b(2 * f * w, _14, _14, _1, 32, 32, 5, norm=True),
            _b(4 * f * w, _116, _116, _1, 8, 8, 5),
            _b(8 * f * w, _132, _132, F(6, 5), 4, 4, 5),
            _b(16 * f * w, _132, _132, F(6, 5), 4, 4, 6, norm=True),
            _b(16 * f * w, _132, _132, F(8, 5), 4, 4, 6),
            _b(8 * f * w, _132, _132, F(8, 5), 4, 4, 8, norm=True),
            _b(4 * f * w, _116, _116, F(9, 5), 4, 4, 8, skip=1),
            _b(2 * f * w, _14, _14, F(2), 8, 8, 8, norm=True, skip=0),
            _b(2 * w, _1, _1, F(2), 32, 32, 8, skip=LIFT),
        ),
        crop_mult=F(2),
    )


def uno3d_t10_256(in_width=6, width=8, pad=2, factor=1, pad_both=False) -> UNOSpec:
    w, f = width, factor
    return _spec3d(
        "uno3d_t10_256", in_width, w, pad, pad_both, w // 2,
        (
            _b(2 * f * w, _14, _14, _1, 32, 32, 5, norm=True),
            _b(4 * f * w, _116, _116, _1, 8, 8, 4),
            _b(8 * f * w, _132, _132, F(4, 5), 4, 4, 4),
            _b(16 * f * w, _132, _132, F(4, 5), 4, 4, 4, norm=True),
            _b(16 * f * w, _132, _132, F(4, 5), 4, 4, 4),
            _b(8 * f * w, _132, _132, F(4, 5), 4, 4, 4, norm=True),
            _b(4 * f * w, _116, _116, F(4, 5), 4, 4, 4, skip=1),
            _b(2 * f * w, _14, _14, F(1), 8, 8, 4, norm=True, skip=0),
            _b(2 * w, _1, _1, F(1), 32, 32, 5, skip=LIFT),
        ),
        crop_mult=F(1),
    )


def uno3d_t9_256(in_width=6, width=8, pad=2, factor=1, pad_both=False) -> UNOSpec:
    w, f = width, factor
    return _spec3d(
        "uno3d_t9_256", in_width, w, pad, pad_both, w // 2,
        (
            _b(2 * f * w, _14, _14, _1, 32, 32, 3, norm=True),
            _b(4 * f * w, _116, _116, _1, 8, 8, 3),
            _b(8 * f * w, _132, _132, _1, 4, 4, 3),
            _b(16 * f * w, _132, _132, F(4, 3), 4, 4, 3, norm=True),
            _b(16 * f * w, _132, _132, F(4, 3), 4, 4, 4),
            _b(8 * f * w, _132, _132, F(4, 3), 4, 4, 4, norm=True),
            _b(4 * f * w, _116, _116, F(4, 3), 4, 4, 4, skip=1),
            _b(2 * f * w, _14, _14, F(3, 2), 4, 4, 4, norm=True, skip=0),
            _b(2 * w, _1, _1, F(3, 2), 32, 32, 4, skip=LIFT),
        ),
        crop_mult=F(3, 2),
    )
