"""Plain float32 U-NO 2-D: the reference that decides ``correct``.

Written from the upstream code's equations (ashiq24/UNO:
``integral_operators.py`` SpectralConv2d_Uno, pointwise_op_2D,
OperatorBlock_2D; ``darcy_flow_uno2d.py`` UNO_9; ``navier_stokes_uno2d.py``
UNO), interpreting a configuration file's ``model`` section.  It imports
nothing of the program under test: plain ``torch`` operations only, run
with TF32 off (the harness sets ``allow_tf32`` False for the process).

* lift: ``gelu(fc0(gelu(fc(cat(x, grid)))))``, channels-last
* padding: darcy ``ceil(S / 85) * pad`` after the last row and column; sym
  ``pad`` on both sides
* block: ``gelu(norm(K(u) + W(u)))`` with
  - K: ``rfft2(norm="forward")``, the ``[:m1, :m2]`` and ``[-m1:, :m2]``
    corners times their complex weights (``einsum('bixy,ioxy->boxy')``),
    written in that order into a zero spectrum of the output grid, then the
    inverse: ``ifft`` over rows, the imaginary part of the column transform's
    DC (and Nyquist) bin dropped, ``irfft`` over columns (what a c2r
    transform takes of a half spectrum)
  - W: a 1x1 conv, then ``interpolate(bicubic, align_corners=True,
    antialias=True)`` to the output grid
  - norm: ``instance_norm(eps=1e-5)`` with its affine scale and bias
* skips: ``cat([block output, source])`` on channels; the source is the
  padded lift output or an earlier block's output
* crop to the input grid, then ``fc2(gelu(fc1(u)))``

``quant`` rounds a tensor where the configuration's precision policy rounds
to bf16 (the lift and 1x1 convs' inputs, weights and outputs, every block
output, the head's input).  The reference itself passes none.  With
``bf16_round`` it gives the rounding scale of the configuration's own
precision, the unit in which the program's distance from the reference is
measured; the control passes a rounding to float8 (``fp8_round``), the
precision below bf16.

The ``uno2d`` family's other declarations (``benchmark/plugins.py``): the
configuration keys it reads, ``leaves``, ``check_spec``, and the counts of
its work (``step_flops``, ``bounds``, from ``uno2d_counts.py``).
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.uno2d_counts import bounds, step_flops  # noqa: F401

# the configuration keys the family reads: top-level ones beyond the
# harness's own, the ``model`` section's (all present), and a block's
CONFIG_KEYS = {"grid", "t_in", "t_f"}
MODEL_KEYS = {"in_width", "width", "lift_hidden", "embed", "pad", "pad_mode", "darcy_base",
              "blocks", "proj_hidden", "proj_concat_lift", "out_dim", "precision"}
BLOCK_KEYS = {"channels", "grid", "modes", "normalize", "residual", "skip"}

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _round_to(dtype):
    def q(t: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            r = t.to(dtype).to(t.dtype)
        return t + (r - t).detach()

    return q


# ``t`` rounded to bf16 (the configuration's policy) or to float8 e4m3 (the
# precision below it) and back, the gradient passed straight through
bf16_round = _round_to(torch.bfloat16)
fp8_round = _round_to(torch.float8_e4m3fn)


def _frac(g) -> Fraction:
    return Fraction(g) if isinstance(g, str) else Fraction(g)


def _skip_channels(model: dict) -> List[int]:
    """The channels of each block's output after its skip concat."""
    chans: List[int] = []
    for blk in model["blocks"]:
        c = blk["channels"]
        skip = blk.get("skip")
        if skip == "lift":
            c += model["width"]
        elif skip is not None:
            c += chans[skip]
        chans.append(c)
    return chans


def block_inputs(model: dict) -> List[int]:
    """The input channels of each block."""
    return [model["width"]] + _skip_channels(model)[:-1]


def leaves(model: dict) -> List[Tuple[str, tuple, str, float]]:
    """Every weight as (name, shape, law, scale): ``uniform`` on (-scale,
    scale), ``cnormal`` complex with re and im from N(0, scale^2 / 2),
    ``ones``, ``zeros``.  A Dense or 1x1 conv weight is (out, in)."""
    out: List[Tuple[str, tuple, str, float]] = []

    def dense(name, fan_in, fan_out):
        k = 1.0 / math.sqrt(fan_in)
        out.append((f"{name}.weight", (fan_out, fan_in), "uniform", k))
        out.append((f"{name}.bias", (fan_out,), "uniform", k))

    dense("fc", model["in_width"], model["lift_hidden"])
    dense("fc0", model["lift_hidden"], model["width"])
    for i, (ci, blk) in enumerate(zip(block_inputs(model), model["blocks"])):
        co, (m1, m2) = blk["channels"], blk["modes"]
        out.append((f"block{i}.conv.weights", (2, ci, co, m1, m2), "cnormal",
                    math.sqrt(1.0 / (2.0 * ci))))
        dense(f"block{i}.w", ci, co)
        if blk.get("normalize"):
            out.append((f"block{i}.norm_scale", (co,), "ones", 1.0))
            out.append((f"block{i}.norm_bias", (co,), "zeros", 0.0))
    last = _skip_channels(model)[-1]
    dense("fc1", last, model["proj_hidden"])
    head_in = model["proj_hidden"] + (model["lift_hidden"] if model["proj_concat_lift"] else 0)
    dense("fc2", head_in, model["out_dim"])
    return out


def check_spec(spec, model: dict) -> None:
    """The program's spec is the architecture the configuration describes."""
    want = {k: model[k] for k in ("in_width", "width", "lift_hidden", "embed", "pad",
                                  "pad_mode", "darcy_base", "proj_hidden",
                                  "proj_concat_lift", "out_dim")}
    got = {k: getattr(spec, k) for k in want}
    blocks = [(b["channels"], Fraction(b["grid"]), tuple(b["modes"]), bool(b.get("normalize")),
               bool(b.get("residual")), -1 if b.get("skip") == "lift" else b.get("skip"))
              for b in model["blocks"]]
    got_blocks = [(b.channels, b.grid[0], tuple(b.modes), b.normalize, b.residual, b.skip)
                  for b in spec.blocks]
    if got != want or got_blocks != blocks or any(b.grid[0] != b.grid[1] for b in spec.blocks):
        raise ValueError(f"the program's {spec.name} is not the configuration's model: "
                         f"{got} {got_blocks} against {want} {blocks}")
    if spec.dtype != model["precision"]:
        raise ValueError(f"the program runs {spec.dtype}, the configuration states "
                         f"{model['precision']}")


def _grid(embed: str, b: int, s1: int, s2: int, device) -> torch.Tensor:
    if embed == "linear2d":
        end = 1.0
    elif embed == "sincos2d":
        end = 2.0 * math.pi
    else:
        raise ValueError(f"embedding {embed!r}")
    gx = torch.linspace(0.0, end, s1, device=device)[None, :, None, None].expand(b, s1, s2, 1)
    gy = torch.linspace(0.0, end, s2, device=device)[None, None, :, None].expand(b, s1, s2, 1)
    if embed == "linear2d":
        return torch.cat([gx, gy], dim=-1)
    return torch.cat([gx.sin(), gy.sin(), gx.cos(), gy.cos()], dim=-1)


def _pads(model: dict, s2: int) -> Tuple[int, int]:
    """(before, after) padding of both grid axes."""
    if model["pad_mode"] == "darcy":
        return 0, math.ceil(s2 / model["darcy_base"]) * model["pad"]
    if model["pad_mode"] == "sym":
        return model["pad"], model["pad"]
    raise ValueError(f"pad_mode {model['pad_mode']!r}")


def _irfft2(spec: torch.Tensor, d1: int, d2: int) -> torch.Tensor:
    """The real field of a half spectrum (rows full, columns halved), no
    scaling: rows inverted as complex, then each row's half spectrum taken
    as a real signal's, its DC and Nyquist bins real."""
    z = torch.fft.ifft(spec, dim=-2, norm="forward")
    keep = torch.ones(z.shape[-1], 2, device=z.device)
    keep[0, 1] = 0.0
    if d2 % 2 == 0 and d2 // 2 < z.shape[-1]:
        keep[d2 // 2, 1] = 0.0
    z = torch.view_as_complex(torch.view_as_real(z) * keep)
    return torch.fft.irfft(z, n=d2, dim=-1, norm="forward")


def spectral_conv(x: torch.Tensor, w: torch.Tensor, d1: int, d2: int,
                  modes: Tuple[int, int]) -> torch.Tensor:
    """SpectralConv2d_Uno: (B, Ci, H, W) -> (B, Co, d1, d2)."""
    m1, m2 = modes
    x_ft = torch.fft.rfft2(x, norm="forward")
    b, co = x.shape[0], w.shape[2]
    out_ft = torch.zeros((b, co, d1, d2 // 2 + 1), dtype=torch.complex64, device=x.device)
    out_ft[:, :, :m1, :m2] = torch.einsum("bixy,ioxy->boxy", x_ft[:, :, :m1, :m2], w[0])
    out_ft[:, :, -m1:, :m2] = torch.einsum("bixy,ioxy->boxy", x_ft[:, :, -m1:, :m2], w[1])
    return _irfft2(out_ft, d1, d2)


def _dense(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str, q) -> torch.Tensor:
    return q(F.linear(q(x), q(p[f"{name}.weight"]), q(p[f"{name}.bias"])))


def pointwise(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str, d1: int, d2: int,
              q) -> torch.Tensor:
    """pointwise_op_2D: 1x1 conv, then bicubic antialiased to (d1, d2)."""
    y = _dense(x.movedim(1, -1), p, name, q).movedim(-1, 1)
    if tuple(y.shape[-2:]) != (d1, d2):
        y = F.interpolate(y, size=(d1, d2), mode="bicubic", align_corners=True, antialias=True)
    return y


def forward(model: dict, p: Dict[str, torch.Tensor], x: torch.Tensor,
            quant: Quant = None) -> torch.Tensor:
    """x (B, S1, S2, C) channels-last f32 -> (B, S1, S2, out_dim) f32."""
    q = quant or (lambda t: t)
    b, s1, s2, _ = x.shape
    x = torch.cat([x.float(), _grid(model["embed"], b, s1, s2, x.device)], dim=-1)
    h = q(F.gelu(_dense(x, p, "fc", q)))
    v = q(F.gelu(_dense(h, p, "fc0", q))).movedim(-1, 1)
    lo, hi = _pads(model, s2)
    if lo or hi:
        v = F.pad(v, (lo, hi, lo, hi))
    base = v.shape[-2:]
    outs: List[torch.Tensor] = []
    cur = v
    for i, blk in enumerate(model["blocks"]):
        g = _frac(blk["grid"])
        d1, d2 = (n * g.numerator // g.denominator for n in base)
        out = (spectral_conv(cur, p[f"block{i}.conv.weights"], d1, d2, tuple(blk["modes"]))
               + pointwise(cur, p, f"block{i}.w", d1, d2, q))
        if blk.get("normalize"):
            out = F.instance_norm(out, weight=p[f"block{i}.norm_scale"],
                                  bias=p[f"block{i}.norm_bias"], eps=1e-5)
        if blk.get("residual"):
            out = out + cur
        cur = q(F.gelu(out))
        skip = blk.get("skip")
        if skip is not None:
            cur = torch.cat([cur, v if skip == "lift" else outs[skip]], dim=1)
        outs.append(cur)
    cur = cur[..., lo : lo + s1, lo : lo + s2].movedim(1, -1)
    y = F.gelu(F.linear(q(cur), p["fc1.weight"], p["fc1.bias"]))
    if model["proj_concat_lift"]:
        y = torch.cat([y, h], dim=-1)
    return F.linear(y, p["fc2.weight"], p["fc2.bias"])


def rel_l2_sum(out: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """LpLoss(p=2, reduction sum): per sample ||out - y|| / ||y||, summed."""
    b = y.shape[0]
    d = (out.reshape(b, -1) - y.reshape(b, -1)).norm(dim=1)
    return (d / y.reshape(b, -1).norm(dim=1)).sum()


def rollout(model: dict, p: Dict[str, torch.Tensor], xx: torch.Tensor, t_f: int,
            quant: Quant = None) -> torch.Tensor:
    """The autoregressive rollout: each prediction appended to the input
    window, the oldest frame dropped; (B, S, S, T_in) -> (B, S, S, t_f)."""
    xx = xx.float()
    frames = []
    for _ in range(t_f):
        im = forward(model, p, xx, quant)
        frames.append(im[..., 0])
        xx = torch.cat([xx[..., 1:], im], dim=-1)
    return torch.stack(frames, dim=-1)


class Adam:
    """The upstream Adam (Adam.py): L2 weight decay added to the gradient,
    ``exp_avg_sq += (1 - b2) * g * conj(g)`` kept real, bias corrections
    with the 1-based step count; ``lr`` a function of that count."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: Callable[[int], float],
                 weight_decay: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.wd = params, lr, weight_decay
        self.b1, self.b2 = betas
        self.eps = eps
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros(v.shape, device=v.device) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.count += 1
        n = self.count
        bc1, bc2 = 1.0 - self.b1 ** n, 1.0 - self.b2 ** n
        for k, p in self.params.items():
            g = grads[k] + self.wd * p
            self.mu[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            g2 = (g * g.conj()).real if g.is_complex() else g * g
            self.nu[k].mul_(self.b2).add_(g2, alpha=1.0 - self.b2)
            denom = self.nu[k].sqrt() / math.sqrt(bc2) + self.eps
            p.add_(self.mu[k] / denom, alpha=-self.lr(n) / bc1)


def step_lr(base: float, step_epochs: int, gamma: float, steps_per_epoch: int):
    """StepLR stepped once an epoch, as a function of the 1-based step."""
    return lambda n: base * gamma ** ((max(n - 1, 0) // steps_per_epoch) // step_epochs)
