"""The operations and bytes of a U-NO 2-D configuration's work: the
``uno2d`` family's counts, read through ``counts.step_flops`` and
``counts.bounds``.

Counted from the configuration file's shapes, never from the program, so a
later implementation of the same work is held to the same count.

* The contraction of a block, (B, Ci, M) x (Ci, Co, M) -> (B, Co, M) with
  M = 2 m1 m2 complex modes: 8 flops a complex multiply-add and 8 bytes a
  complex64 element.  Its two gradients have the same bound.
* The fused head ``fc2(gelu(fc1(x)))`` over N points: the forward reads x
  in bf16 and the weights, writes f32; the backward reads x and g, writes gx
  (bf16) and the weight gradients, and recomputes the hidden layer.
* A step's flops (``step_flops``): the lift, every block's FFTs (2.5 N log2
  N a real transform of N points), contraction, 1x1 conv and resample (the
  cheaper order), norm, the head and the loss; a training step counts its
  backward as twice the forward.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Dict, List, Tuple

from benchmark.counts import bound_s


def _pads(model: dict, s: int) -> Tuple[int, int]:
    if model["pad_mode"] == "darcy":
        return 0, math.ceil(s / model["darcy_base"]) * model["pad"]
    return model["pad"], model["pad"]


def blocks(model: dict, s: int) -> List[dict]:
    """Per block: input grid, output grid, in and out channels, modes."""
    lo, hi = _pads(model, s)
    base = s + lo + hi
    out, chans = [], []
    grid, ci = base, model["width"]
    for blk in model["blocks"]:
        g = Fraction(blk["grid"])
        d = base * g.numerator // g.denominator
        co = blk["channels"]
        out.append(dict(h=grid, d=d, ci=ci, co=co, modes=tuple(blk["modes"]),
                        normalize=bool(blk.get("normalize"))))
        skip = blk.get("skip")
        c = co + (model["width"] if skip == "lift" else 0 if skip is None else chans[skip])
        chans.append(c)
        grid, ci = d, c
    return out


def contract_shapes(model: dict, s: int, b: int) -> List[Tuple[int, int, int, int]]:
    """(B, Ci, Co, M) of each block's contraction."""
    return [(b, k["ci"], k["co"], 2 * k["modes"][0] * k["modes"][1]) for k in blocks(model, s)]


def contract_bound_s(shape: Tuple[int, int, int, int], peak: Dict[str, float]) -> float:
    b, ci, co, m = shape
    return bound_s(8 * (b * ci * m + ci * co * m + b * co * m), 8.0 * b * co * m * ci, peak)


def head_shape(model: dict, s: int, b: int) -> Tuple[int, int, int, int, int]:
    """(B, C, N, H, O) of the projection head."""
    c = model["blocks"][-1]["channels"]
    skip = model["blocks"][-1].get("skip")
    if skip == "lift":
        c += model["width"]
    return b, c, s * s, model["proj_hidden"], model["out_dim"]


def head_bounds_s(shape, peak: Dict[str, float]) -> Tuple[float, float]:
    """(forward, backward) bounds of the fused head."""
    b, c, n, h, o = shape
    wbytes = 4 * (c * h + h + h * o + o)
    fwd = bound_s(2 * b * c * n + wbytes + 4 * b * o * n, 2.0 * b * n * (c * h + h * o), peak)
    bwd = bound_s(4 * b * c * n + 4 * b * o * n + wbytes - 4 * o + wbytes,
                  2.0 * b * n * (3 * c * h + 2 * h * o), peak)
    return fwd, bwd


def _resample_taps(n_in: int, n_out: int) -> float:
    """Taps a bicubic antialiased output sample reads along one axis."""
    return 4.0 * max((n_in - 1) / max(n_out - 1, 1), 1.0)


def forward_flops(model: dict, s: int, b: int) -> float:
    """Flops of one forward of ``b`` samples at an s x s grid."""
    n = s * s
    fl = 2.0 * b * n * (model["in_width"] * model["lift_hidden"]
                        + model["lift_hidden"] * model["width"])
    for k in blocks(model, s):
        h, d, ci, co = k["h"], k["d"], k["ci"], k["co"]
        m = 2 * k["modes"][0] * k["modes"][1]
        fl += 2.5 * b * ci * h * h * math.log2(h * h) + 2.5 * b * co * d * d * math.log2(d * d)
        fl += 8.0 * b * ci * co * m
        taps = _resample_taps(h, d)
        # resample along both axes: rows first to d, then columns
        resize = lambda c: 2.0 * b * c * taps * (d * h + d * d) if h != d else 0.0  # noqa: E731
        fl += min(2.0 * b * ci * co * h * h + resize(co), resize(ci) + 2.0 * b * ci * co * d * d)
        if k["normalize"]:
            fl += 8.0 * b * co * d * d
    _, c, _, hid, o = head_shape(model, s, b)
    fl += 2.0 * b * n * (c * hid + hid * o)
    return fl


def step_flops(cfg: dict, b: int, kind: str) -> float:
    """Flops of one training step (``train``: forward, loss, backward) or
    one served batch (``serve``: a forward, or a rollout of t_f of them)."""
    s, model = cfg["grid"], cfg["model"]
    fwd = forward_flops(model, s, b) + 4.0 * b * s * s * model["out_dim"]
    if kind == "train":
        return 3.0 * fwd
    return fwd * (cfg.get("t_f") or 1)


def bounds(cfg: dict, b: int, kind: str, peak: Dict[str, float]) -> Dict[str, float]:
    """Seconds a step (``train``) or a served batch (``serve``) needs at the
    bound: the contraction's launches and the head's."""
    s, model = cfg["grid"], cfg["model"]
    forwards = 1 if kind == "train" else (cfg.get("t_f") or 1)
    uses = 3 if kind == "train" else 1  # forward, dx, dw
    contract = forwards * uses * sum(contract_bound_s(sh, peak)
                                     for sh in contract_shapes(model, s, b))
    fwd, bwd = head_bounds_s(head_shape(model, s, b), peak)
    head = forwards * (fwd + (bwd if kind == "train" else 0.0))
    return {"contract_s": contract, "head_s": head}
