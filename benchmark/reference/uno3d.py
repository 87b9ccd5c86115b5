"""Plain float32 U-NO 3-D (space and time): the reference that decides
``correct`` for the NS-3D configurations.

Written from the upstream code's equations (ashiq24/UNO:
``integral_operators.py`` SpectralConv3d_Uno :287-427, pointwise_op_3D
:430-468, OperatorBlock_3D :471-513; ``navier_stokes_uno3d.py`` Uno3D_T40
:22-212), interpreting a configuration file's ``model`` section.  It imports
nothing of the program under test: plain ``torch`` operations only, run with
TF32 off (the harness sets ``allow_tf32`` False for the process).

* embedding: ``sin x, sin y, cos x, cos y`` with x, y on ``linspace(0, 2 pi)``
  and ``t`` on ``linspace(0, 1)`` over the input frames (5 channels)
* lift: ``gelu(fc0(gelu(fc(cat(x, grid)))))``, channels-last
* time pad: ``int(pad * 0.1 * T)`` zero frames after the last one (before
  the first as well with ``pad_both``)
* block: ``gelu(norm(K(u) + W(u)))`` with
  - K: ``rfftn(norm="forward")`` over (x, y, t); the four sign quadrants
    ``[:m1, :m2, :m3]``, ``[-m1:, :m2, :m3]``, ``[:m1, -m2:, :m3]``,
    ``[-m1:, -m2:, :m3]`` times their complex weights
    (``einsum('bixyz,ioxyz->boxyz')``), written in that order into a zero
    spectrum of the output grid, so that where they overlap the negative
    blocks win; then the inverse (``_irfftn``, forward norm)
  - W: a 1x1 conv; then the explicit Fourier truncation in the default
    ("backward") norm: the unnormalised ``rfftn``, the four quadrants of
    ``d // 2`` bins per axis (the output's sizes) copied at their own
    indices into a zero spectrum of the input's shape, and the inverse to
    the output grid, which trims or zero-pads the trailing bins of each
    axis; then ``interpolate(trilinear, align_corners=True)`` to the output
    grid (the identity there, kept as upstream has it)
  - norm: ``instance_norm(eps=1e-5)`` with its affine scale and bias
* skips: the source (the padded lift output or an earlier block's output)
  resized ``trilinear, align_corners=True`` to the block output's grid and
  concatenated after it on channels
* the time padding cropped, ``floor(crop_mult * pad)`` frames from each
  padded side, then ``fc2(gelu(fc1(u)))`` in float32

Departures from the upstream code, none of which changes the function:

* the grid sizes are exact floors of fractions (``D3 * 8/5``), where
  upstream takes ``int(D3 * 1.6)`` of a float; at the configurations' sizes
  the two agree;
* a 1x1 conv's weight is (out, in), the four spectral weights one stacked
  tensor (4, in, out, m1, m2, m3), under the program's parameter names, so
  that both sides load one set of weights;
* the inverse of a half spectrum is written out (``_irfftn``): the full axes
  inverted as complex, then the imaginary parts of the last axis's DC and
  Nyquist bins dropped before its real inverse.  That is what upstream's
  ``irfftn`` computes on the CPU (pocketfft); cuFFT's c2r answers
  differently for some plans when those bins are not Hermitian, as a
  U-NO's output spectrum is not;
* upstream overwrites its ``padding`` attribute at each forward with
  ``int(padding * 0.1 * T)``; the configurations' ``pad`` and ``T`` are its
  fixed point (3 frames of 10), and the pad is taken once.

``quant`` rounds tensors where a precision check needs them rounded; the
reference itself passes none, and each rounding says where it applies
(its ``where``):

* ``bf16_round`` (``"policy"``) rounds to bf16 where the program's bf16
  policy rounds (the lift's and the 1x1 convs' inputs, weights and outputs,
  every block output, the head's input).  The harness measures the
  program's distance from this reference in units of this rounding's
  distance: for a float32 configuration, how far the bf16 policy would
  move the same numbers.
* ``fp8_round`` (``"operands"``) is the control: every operand of a matmul,
  an einsum (the spectral contraction) and a 1x1 conv rounded to TF32 (a
  10-bit mantissa, to nearest), the precision just below float32 on the
  H100.  For a bf16 configuration the precision below is float8 (``uno2d``);
  the hook keeps the harness's name.

The ``uno3d`` family's other declarations (``benchmark/plugins.py``): the
configuration keys it reads, ``leaves``, ``check_spec``, and the counts of
its work (``step_flops``, ``bounds``, from ``uno3d_counts.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.uno2d import (  # noqa: F401
    Adam, _frac, _round_to, _skip_channels, block_inputs, rel_l2_sum, step_lr)
from benchmark.reference.uno3d_counts import (  # noqa: F401
    block_grids, bounds, step_flops, time_pads)

# the configuration keys the family reads: top-level ones beyond the
# harness's own, the ``model`` section's (all present), and a block's
CONFIG_KEYS = {"grid", "t_in", "t_f"}
MODEL_KEYS = {"in_width", "width", "lift_hidden", "embed", "pad", "pad_mode", "pad_both",
              "crop_mult", "blocks", "proj_hidden", "out_dim", "precision"}
BLOCK_KEYS = {"channels", "grid", "time", "modes", "normalize", "skip"}

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 (or the parts of complex64) to a 10-bit mantissa, the nearest
    value, halves away from zero (the card's ``cvt.rna.tf32.f32``)."""
    with torch.no_grad():
        f = torch.view_as_real(t) if t.is_complex() else t
        bits = f.contiguous().view(torch.int32)
        r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        r = torch.view_as_complex(r) if t.is_complex() else r
    return t + (r - t).detach()  # the gradient passed straight through


# the harness's two hooks (``traffic/train_step.py``): the unit's rounding
# and the control's
bf16_round = _round_to(torch.bfloat16)
bf16_round.where = "policy"
fp8_round = _tf32
fp8_round.where = "operands"


def _points(quant: Quant) -> Tuple[Callable, Callable]:
    """(the rounding at the bf16 policy's points, at every product's operands)."""
    ident = lambda t: t  # noqa: E731
    where = getattr(quant, "where", "policy") if quant is not None else None
    return (quant if where == "policy" else ident), (quant if where == "operands" else ident)


def leaves(model: dict) -> List[Tuple[str, tuple, str, float]]:
    """Every weight as (name, shape, law, scale): ``uniform`` on (-scale,
    scale), ``cnormal`` complex with re and im from N(0, scale^2 / 2),
    ``ones``, ``zeros``.  A Dense or 1x1 conv weight is (out, in); a block's
    spectral weights are its four quadrants' stacked."""
    out: List[Tuple[str, tuple, str, float]] = []

    def dense(name, fan_in, fan_out):
        k = 1.0 / math.sqrt(fan_in)
        out.append((f"{name}.weight", (fan_out, fan_in), "uniform", k))
        out.append((f"{name}.bias", (fan_out,), "uniform", k))

    dense("fc", model["in_width"], model["lift_hidden"])
    dense("fc0", model["lift_hidden"], model["width"])
    for i, (ci, blk) in enumerate(zip(block_inputs(model), model["blocks"])):
        co = blk["channels"]
        out.append((f"block{i}.conv.weights", (4, ci, co, *blk["modes"]), "cnormal",
                    math.sqrt(1.0 / (2.0 * ci))))
        dense(f"block{i}.w", ci, co)
        if blk.get("normalize"):
            out.append((f"block{i}.norm_scale", (co,), "ones", 1.0))
            out.append((f"block{i}.norm_bias", (co,), "zeros", 0.0))
    dense("fc1", _skip_channels(model)[-1], model["proj_hidden"])
    dense("fc2", model["proj_hidden"], model["out_dim"])
    return out


def check_spec(spec, model: dict) -> None:
    """The program's spec is the architecture the configuration describes:
    the lift, the time pad and its crop, and each block's channels, grid
    factor on both space axes, time factor, modes, norm and skip."""
    want = {k: model[k] for k in ("in_width", "width", "lift_hidden", "embed", "pad",
                                  "pad_mode", "pad_both", "proj_hidden", "out_dim")}
    want.update(ndim=3, crop_mult=_frac(model["crop_mult"]), proj_concat_lift=False)
    got = {k: getattr(spec, k) for k in want}
    blocks = [(b["channels"], (_frac(b["grid"]), _frac(b["grid"]), _frac(b["time"])),
               tuple(b["modes"]), bool(b.get("normalize")), False,
               -1 if b.get("skip") == "lift" else b.get("skip"))
              for b in model["blocks"]]
    got_blocks = [(b.channels, tuple(b.grid), tuple(b.modes), b.normalize, b.residual, b.skip)
                  for b in spec.blocks]
    if got != want or got_blocks != blocks or spec.pad_to is not None:
        raise ValueError(f"the program's {spec.name} is not the configuration's model: "
                         f"{got} {got_blocks} against {want} {blocks}")
    if spec.dtype != model["precision"]:
        raise ValueError(f"the program runs {spec.dtype}, the configuration states "
                         f"{model['precision']}")


def _grid(embed: str, b: int, s1: int, s2: int, t: int, device) -> torch.Tensor:
    """(B, S1, S2, T, 5): sin x, sin y, cos x, cos y, t."""
    if embed != "sincos3d":
        raise ValueError(f"embedding {embed!r}")
    gx = torch.linspace(0.0, 2.0 * math.pi, s1, device=device)[None, :, None, None, None]
    gy = torch.linspace(0.0, 2.0 * math.pi, s2, device=device)[None, None, :, None, None]
    gt = torch.linspace(0.0, 1.0, t, device=device)[None, None, None, :, None]
    shape = (b, s1, s2, t, 1)
    return torch.cat([gx.sin().expand(shape), gy.sin().expand(shape), gx.cos().expand(shape),
                      gy.cos().expand(shape), gt.expand(shape)], dim=-1)


def _fit(spec: torch.Tensor, sizes: Tuple[int, int, int]) -> torch.Tensor:
    """The last three axes trimmed or zero-padded at their ends to ``sizes``."""
    have = spec.shape[-3:]
    out = spec.new_zeros(spec.shape[:-3] + tuple(sizes))
    n = [min(a, b) for a, b in zip(have, sizes)]
    out[..., : n[0], : n[1], : n[2]] = spec[..., : n[0], : n[1], : n[2]]
    return out


def _irfftn(spec: torch.Tensor, s: Tuple[int, int, int], norm: str) -> torch.Tensor:
    """``irfftn(spec, s=s, dim=(-3, -2, -1), norm=norm)`` as pocketfft takes
    it: the spectrum fitted to ``s`` (the last axis to ``s[-1] // 2 + 1``),
    the two full axes inverted as complex, the last axis's DC and Nyquist
    bins taken real, then its real inverse."""
    d1, d2, d3 = s
    z = _fit(spec, (d1, d2, d3 // 2 + 1))
    z = torch.fft.ifft(torch.fft.ifft(z, dim=-3, norm=norm), dim=-2, norm=norm)
    keep = torch.ones(z.shape[-1], 2, device=z.device)
    keep[0, 1] = 0.0
    if d3 % 2 == 0:
        keep[d3 // 2, 1] = 0.0
    z = torch.view_as_complex(torch.view_as_real(z) * keep)
    return torch.fft.irfft(z, n=d3, dim=-1, norm=norm)


def spectral_conv(x: torch.Tensor, w: torch.Tensor, out: Tuple[int, int, int],
                  modes: Tuple[int, int, int], qo) -> torch.Tensor:
    """SpectralConv3d_Uno: (B, Ci, X, Y, T) -> (B, Co, d1, d2, d3)."""
    m1, m2, m3 = modes
    d1, d2, d3 = out
    x_ft = torch.fft.rfftn(x, dim=(-3, -2, -1), norm="forward")
    b, co = x.shape[0], w.shape[2]
    out_ft = torch.zeros((b, co, d1, d2, d3 // 2 + 1), dtype=torch.complex64, device=x.device)
    quads = [(slice(None, m1), slice(None, m2)), (slice(-m1, None), slice(None, m2)),
             (slice(None, m1), slice(-m2, None)), (slice(-m1, None), slice(-m2, None))]
    for k, (sx, sy) in enumerate(quads):
        out_ft[:, :, sx, sy, :m3] = torch.einsum("bixyz,ioxyz->boxyz",
                                                 qo(x_ft[:, :, sx, sy, :m3]), qo(w[k]))
    return _irfftn(out_ft, out, "forward")


def truncate(x: torch.Tensor, out: Tuple[int, int, int]) -> torch.Tensor:
    """pointwise_op_3D's Fourier truncation, default norm."""
    h1, h2, h3 = (d // 2 for d in out)
    ft = torch.fft.rfftn(x, dim=(-3, -2, -1))
    ft_u = torch.zeros_like(ft)
    for sx, sy in [(slice(None, h1), slice(None, h2)), (slice(-h1, None), slice(None, h2)),
                   (slice(None, h1), slice(-h2, None)), (slice(-h1, None), slice(-h2, None))]:
        ft_u[:, :, sx, sy, :h3] = ft[:, :, sx, sy, :h3]
    return _irfftn(ft_u, out, "backward")


def _dense(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str, qp, qo) -> torch.Tensor:
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    return qp(F.linear(qo(qp(x)), qo(qp(w)), qp(b)))


def pointwise(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str,
              out: Tuple[int, int, int], qp, qo) -> torch.Tensor:
    """pointwise_op_3D: 1x1 conv, the truncation, trilinear to ``out``."""
    y = _dense(x.movedim(1, -1), p, name, qp, qo).movedim(-1, 1)
    y = truncate(y.float(), out)
    return F.interpolate(y, size=out, mode="trilinear", align_corners=True)


def forward(model: dict, p: Dict[str, torch.Tensor], x: torch.Tensor,
            quant: Quant = None) -> torch.Tensor:
    """x (B, S1, S2, T, C) channels-last f32 -> (B, S1, S2, T_out, out_dim) f32."""
    qp, qo = _points(quant)
    b, s1, s2, t, _ = x.shape
    x = torch.cat([x.float(), _grid(model["embed"], b, s1, s2, t, x.device)], dim=-1)
    h = qp(F.gelu(_dense(x, p, "fc", qp, qo)))
    v = qp(F.gelu(_dense(h, p, "fc0", qp, qo))).movedim(-1, 1)
    if model["pad_mode"] != "time":
        raise ValueError(f"pad_mode {model['pad_mode']!r}")
    lo, hi = time_pads(model, t)
    if lo or hi:
        v = F.pad(v, (lo, hi))
    grids = block_grids(model, (s1, s2, t + lo + hi))
    outs: List[torch.Tensor] = []
    cur = v
    for i, blk in enumerate(model["blocks"]):
        out = grids[i]
        y = (spectral_conv(cur, p[f"block{i}.conv.weights"], out, tuple(blk["modes"]), qo)
             + pointwise(cur, p, f"block{i}.w", out, qp, qo))
        if blk.get("normalize"):
            y = F.instance_norm(y, weight=p[f"block{i}.norm_scale"],
                                bias=p[f"block{i}.norm_bias"], eps=1e-5)
        cur = qp(F.gelu(y))
        skip = blk.get("skip")
        if skip is not None:
            src = v if skip == "lift" else outs[skip]
            src = F.interpolate(src, size=out, mode="trilinear", align_corners=True)
            cur = torch.cat([cur, src], dim=1)
        outs.append(cur)
    crop = _frac(model["crop_mult"])
    c_lo, c_hi = math.floor(crop * lo), math.floor(crop * hi)
    cur = cur[..., c_lo : cur.shape[-1] - c_hi].movedim(1, -1)
    y = F.gelu(F.linear(qo(qp(cur)), qo(p["fc1.weight"]), p["fc1.bias"]))
    return F.linear(qo(y), qo(p["fc2.weight"]), p["fc2.bias"])
