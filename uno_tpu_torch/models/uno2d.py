"""2D U-NO model family (Darcy flow + Navier-Stokes 2D).

Factories produce ``UNOSpec``s interpreted by ``UNOModel``:

* ``uno9``   — 5-block Darcy model (darcy_flow_uno2d.py:27-141, ``UNO_9``)
* ``uno11``  — 7-block deep Darcy model (darcy_flow_uno2d.py:146-267,
  ``UNO_11``).  The reference version is unrunnable (``residual=True`` is
  passed but never implemented — TypeError at construction); here residual
  is implemented, so this model actually works.
* ``uno_p``  — 7-block factor-2 NS-2D model (navier_stokes_uno2d.py:24-138)
* ``uno``    — 7-block factor-3/4 NS-2D model, the reference script's default
  (navier_stokes_uno2d.py:145-238)
* ``uno_s256`` — aggressive-contraction 256² NS-2D model
  (navier_stokes_uno2d.py:246-337)
* ``uno_demo`` — 13-block pedagogical model from UNO_Tutorial.ipynb cell 20

Note: the reference ``UNO`` pads both sides but crops only the trailing edge
(navier_stokes_uno2d.py:201,218) — a latent shape bug whenever pad != 0 (the
entry script uses pad=0).  We crop symmetrically.

A framework-free copy of ``uno_tpu/models/uno2d.py`` (the JAX package cannot
be imported where the port runs); tests/test_torch_guards.py holds every
factory field-for-field equal to the original.
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


def _b(ch, g1, g2, m1, m2, norm=False, skip=None, residual=False):
    return BlockSpec(
        channels=int(ch),
        grid=(g1, g2),
        modes=(m1, m2),
        normalize=norm,
        residual=residual,
        skip=skip,
    )


def uno9(in_width: int = 3, width: int = 32, pad: int = 5, factor: float = 1) -> UNOSpec:
    w = width
    return UNOSpec(
        name="uno9",
        ndim=2,
        in_width=in_width,
        width=w,
        lift_hidden=w // 2,
        embed="linear2d",
        pad=pad,
        pad_mode="darcy",
        blocks=(
            _b(2 * factor * w, _12, _12, 18, 18),
            _b(4 * factor * w, _14, _14, 8, 8, norm=True),
            _b(4 * factor * w, _14, _14, 8, 8),
            _b(2 * factor * w, _12, _12, 8, 8, norm=True, skip=0),
            _b(w, _1, _1, 18, 18, skip=LIFT),
        ),
        proj_hidden=w,
    )


def uno11(in_width: int = 3, width: int = 32, pad: int = 5, factor: float = 1) -> UNOSpec:
    w = width
    return UNOSpec(
        name="uno11",
        ndim=2,
        in_width=in_width,
        width=w,
        lift_hidden=w // 2,
        embed="linear2d",
        pad=pad,
        pad_mode="darcy",
        blocks=(
            _b(2 * factor * w, _12, _12, 18, 18),
            _b(4 * factor * w, _14, _14, 8, 8, norm=True),
            _b(8 * factor * w, _18, _18, 3, 3),
            _b(8 * factor * w, _18, _18, 3, 3, norm=True, residual=True),
            _b(4 * factor * w, _14, _14, 3, 3, skip=1),
            _b(2 * factor * w, _12, _12, 8, 8, norm=True, skip=0),
            _b(w, _1, _1, 18, 18, skip=LIFT),
        ),
        proj_hidden=w,
    )


def uno_p(in_width: int = 14, width: int = 32, pad: int = 0, factor: float = 1) -> UNOSpec:
    w = width
    return UNOSpec(
        name="uno_p",
        ndim=2,
        in_width=in_width,
        width=w,
        lift_hidden=w // 2,
        embed="sincos2d",
        pad=pad,
        pad_mode="sym",
        blocks=(
            _b(2 * factor * w, _12, _12, 14, 14),
            _b(4 * factor * w, _14, _14, 6, 6),
            _b(8 * factor * w, _18, _18, 3, 3),
            _b(8 * factor * w, _18, _18, 3, 3),
            _b(4 * factor * w, _14, _14, 3, 3, skip=1),
            _b(2 * factor * w, _12, _12, 6, 6, skip=0),
            _b(w, _1, _1, 14, 14, skip=LIFT),
        ),
        proj_hidden=3 * w,
        proj_concat_lift=True,
    )


def uno(in_width: int = 14, width: int = 32, pad: int = 0, factor: float = 3 / 4) -> UNOSpec:
    w = width
    fac = F(factor).limit_denominator(64)
    return UNOSpec(
        name="uno",
        ndim=2,
        in_width=in_width,
        width=w,
        lift_hidden=w // 2,
        embed="sincos2d",
        pad=pad,
        pad_mode="sym",
        blocks=(
            _b(2 * factor * w, fac, fac, 22, 22),
            _b(4 * factor * w, _12, _12, 14, 14),
            _b(8 * factor * w, _14, _14, 6, 6),
            _b(8 * factor * w, _14, _14, 6, 6),
            _b(4 * factor * w, _12, _12, 6, 6, skip=1),
            _b(2 * factor * w, fac, fac, 14, 14, skip=0),
            _b(w, _1, _1, 22, 22, skip=LIFT),
        ),
        proj_hidden=4 * w,
    )


def uno_s256(in_width: int = 14, width: int = 32, pad: int = 0, factor: float = 1) -> UNOSpec:
    w = width
    return UNOSpec(
        name="uno_s256",
        ndim=2,
        in_width=in_width,
        width=w,
        lift_hidden=16,
        embed="sincos2d",
        pad=pad,
        pad_mode="sym",
        blocks=(
            _b(2 * factor * w, _14, _14, 32, 33),
            _b(4 * factor * w, _116, _116, 8, 9),
            _b(8 * factor * w, _132, _132, 4, 5),
            _b(8 * factor * w, _132, _132, 4, 5),
            _b(4 * factor * w, _116, _116, 4, 5, skip=1),
            _b(2 * factor * w, _14, _14, 8, 9, skip=0),
            _b(w, _1, _1, 32, 32, skip=LIFT),
        ),
        proj_hidden=3 * w,
        proj_concat_lift=True,
    )


def uno_demo(in_width: int = 3, width: int = 32, pad: int = 8) -> UNOSpec:
    """13-block tutorial model (UNO_Tutorial.ipynb cell 20): contraction to
    D/16 with 6 bottleneck blocks at 16w channels, raw (x,y) grid embedding,
    one-sided padding, no final lift concat (fc1: w -> 2w)."""
    w = width
    return UNOSpec(
        name="uno_demo",
        ndim=2,
        in_width=in_width,
        width=w,
        lift_hidden=w // 2,
        embed="linear2d",
        pad=pad,
        pad_mode="end",
        blocks=(
            _b(2 * w, _12, _12, 14, 14),
            _b(4 * w, _14, _14, 6, 6),
            _b(8 * w, _18, _18, 3, 3),
            _b(16 * w, _116, _116, 2, 2),
            _b(16 * w, _116, _116, 2, 2),
            _b(16 * w, _116, _116, 2, 2),
            _b(16 * w, _116, _116, 2, 2),
            _b(16 * w, _116, _116, 2, 2),
            _b(16 * w, _116, _116, 2, 2),
            _b(8 * w, _18, _18, 2, 2, skip=2),
            _b(4 * w, _14, _14, 3, 3, skip=1),
            _b(2 * w, _12, _12, 6, 6, skip=0),
            _b(w, _1, _1, 14, 14),
        ),
        proj_hidden=2 * w,
    )
