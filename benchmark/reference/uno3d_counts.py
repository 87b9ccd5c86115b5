"""The operations and bytes of a U-NO 3-D configuration's work: the
``uno3d`` family's counts, read through ``counts.step_flops`` and
``counts.bounds``.

Counted from the configuration file's shapes, never from the program, so a
later implementation of the same work is held to the same count.

* The contraction of a block, (B, Ci, M) x (Ci, Co, M) -> (B, Co, M) with
  M = 4 m1 m2 m3 complex modes (the four sign quadrants of (kx, ky)): 8
  flops a complex multiply-add and 8 bytes a complex64 element
  (``uno2d_counts.contract_bound_s``).  Its two gradients have the same
  bound.
* The 3-D transforms (``transforms``): each block's spectral conv takes an
  r2c of its input (Ci channels at the input grid) and a c2r of its output
  spectrum (Co channels at the output grid); its 1x1 conv's truncation
  takes an r2c at the input grid and a c2r at the output grid, on
  min(Ci, Co) channels, since the conv and the truncation commute and the
  cheaper order needs only those.  A transform reads its input once and
  writes its output once (4 bytes a real value, 8 a complex one, the half
  spectrum of the last axis, ``n // 2 + 1`` bins) and does 2.5 N log2 N
  flops a signal of N points.  A transform has no weights, so its backward
  is one adjoint transform of the same bytes: an r2c's is a c2r-shaped
  pass and a c2r's an r2c-shaped one (``r2c_backward``, ``c2r_backward``).
* A step's flops (``step_flops``): the lift, every block's transforms,
  contraction, 1x1 conv (at the smaller grid), norm, the skips' trilinear
  resize (8 taps a value), the head and the loss; a training step counts
  its backward as twice the forward.  No ``head_s``: a 3-D model's head is
  two plain matmuls, no kernel of the program.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Dict, List, Tuple

from benchmark.counts import bound_s
from benchmark.reference.uno2d_counts import contract_bound_s

Grid = Tuple[int, int, int]


def _floor(n: int, f) -> int:
    f = Fraction(f)
    return n * f.numerator // f.denominator


def time_pads(model: dict, t: int) -> Tuple[int, int]:
    """(before, after) zero frames of the time axis: ``int(pad * 0.1 * T)``."""
    p = int(model["pad"] * 0.1 * t)
    return (p, p) if model["pad_both"] else (0, p)


def block_grids(model: dict, base: Grid) -> List[Grid]:
    """Each block's output grid from the padded base grid: both space axes
    scaled by the block's ``grid``, time by its ``time``, floored."""
    return [(_floor(base[0], b["grid"]), _floor(base[1], b["grid"]), _floor(base[2], b["time"]))
            for b in model["blocks"]]


def blocks(cfg: dict) -> List[dict]:
    """Per block: input grid, output grid, in and out channels, modes."""
    model, s = cfg["model"], cfg["grid"]
    lo, hi = time_pads(model, cfg["t_in"])
    grid: Grid = (s, s, cfg["t_in"] + lo + hi)
    out, chans, ci = [], [], model["width"]
    for blk, d in zip(model["blocks"], block_grids(model, grid)):
        co = blk["channels"]
        out.append(dict(h=grid, d=d, ci=ci, co=co, modes=tuple(blk["modes"]),
                        normalize=bool(blk.get("normalize")), skip=blk.get("skip")))
        skip = blk.get("skip")
        c = co + (model["width"] if skip == "lift" else 0 if skip is None else chans[skip])
        chans.append(c)
        grid, ci = d, c
    return out


def contract_shapes(cfg: dict, b: int) -> List[Tuple[int, int, int, int]]:
    """(B, Ci, Co, M) of each block's contraction, M = 4 m1 m2 m3."""
    return [(b, k["ci"], k["co"], 4 * math.prod(k["modes"])) for k in blocks(cfg)]


def transforms(cfg: dict, b: int, kind: str) -> List[Tuple[str, int, Grid]]:
    """Every 3-D transform of a training step (``train``) or a forward
    (``serve``): (kind, signals, real grid), kind ``r2c`` or ``c2r`` and in
    training also ``r2c_backward`` and ``c2r_backward``, one a forward
    transform."""
    fwd: List[Tuple[str, int, Grid]] = []
    for k in blocks(cfg):
        fwd += [("r2c", b * k["ci"], k["h"]), ("c2r", b * k["co"], k["d"])]
        c = min(k["ci"], k["co"])
        fwd += [("r2c", b * c, k["h"]), ("c2r", b * c, k["d"])]
    if kind != "train":
        return fwd
    return fwd + [(f"{name}_backward", n, g) for name, n, g in fwd]


def transform_bytes(n: int, g: Grid) -> int:
    """A transform's bytes either way: the real field and its half spectrum."""
    return 4 * n * math.prod(g) + 8 * n * g[0] * g[1] * (g[2] // 2 + 1)


def transform_flops(n: int, g: Grid) -> float:
    points = math.prod(g)
    return 2.5 * n * points * math.log2(points)


def forward_flops(cfg: dict, b: int) -> float:
    """Flops of one forward of ``b`` samples."""
    model, s = cfg["model"], cfg["grid"]
    n_in = s * s * cfg["t_in"]
    fl = 2.0 * b * n_in * (model["in_width"] * model["lift_hidden"]
                           + model["lift_hidden"] * model["width"])
    fl += sum(transform_flops(n, g) for _, n, g in transforms(cfg, b, "serve"))
    chans = {}
    for i, k in enumerate(blocks(cfg)):
        ci, co = k["ci"], k["co"]
        n_out = math.prod(k["d"])
        fl += 8.0 * b * ci * co * 4 * math.prod(k["modes"])
        fl += 2.0 * b * ci * co * min(math.prod(k["h"]), n_out)
        if k["normalize"]:
            fl += 8.0 * b * co * n_out
        skip = k["skip"]
        src = model["width"] if skip == "lift" else 0 if skip is None else chans[skip]
        fl += 2.0 * 8 * b * src * n_out
        chans[i] = co + src
    out_t = cfg["t_f"]
    c, hid, o = chans[len(chans) - 1], model["proj_hidden"], model["out_dim"]
    fl += 2.0 * b * s * s * out_t * (c * hid + hid * o)
    return fl


def step_flops(cfg: dict, b: int, kind: str) -> float:
    """Flops of one training step (``train``: forward, loss, backward) or
    one served batch (``serve``: a forward)."""
    fwd = forward_flops(cfg, b) + 4.0 * b * cfg["grid"] ** 2 * cfg["t_f"]
    return 3.0 * fwd if kind == "train" else fwd


def bounds(cfg: dict, b: int, kind: str, peak: Dict[str, float]) -> Dict[str, float]:
    """Seconds a step (``train``) or a served batch (``serve``) needs at the
    bound: the contraction's launches (``contract_s``) and the 3-D
    transforms (``fft_s``)."""
    uses = 3 if kind == "train" else 1  # forward, dx, dw
    contract = uses * sum(contract_bound_s(sh, peak) for sh in contract_shapes(cfg, b))
    fft = sum(bound_s(transform_bytes(n, g), transform_flops(n, g), peak)
              for _, n, g in transforms(cfg, b, kind))
    return {"contract_s": contract, "fft_s": fft}
