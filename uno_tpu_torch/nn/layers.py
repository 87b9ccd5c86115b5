"""Operator layers: port of ``uno_tpu/nn/layers.py`` (1-, 2- and 3-D; the
number of spatial dimensions is ``len(modes)``).

* ``SpectralConv``  — truncated-mode Fourier integral operator
* ``PointwiseOp``   — 1x1 channel conv + resampling: linear-antialias in
  1-D, bicubic-antialias in 2-D, the Fourier truncation then an (identity)
  trilinear resize in 3-D
* ``OperatorBlock`` — u' = GELU(InstanceNorm(K(u) + W(u)))

Initialisation matches ``uno_tpu``'s distributions, drawn from an explicit
``torch.Generator`` on the CPU and then moved to ``device``: Dense and 1x1
conv weights and biases ~ U(-k, k) with k = 1/sqrt(fan_in); spectral weights
~ scale * complex-normal; norm affine = (1, 0).

Weights are stored in torch's layout: a Dense or 1x1 conv weight is
``[out, in]`` (flax keeps ``[in, out]``; ``uno_tpu_torch/bridge.py``
transposes).  Layers take channels-first ``(B, C, *spatial)`` input and an
``out_size`` grid at call time.  Under the bf16 policy the matmuls run in
bf16 with f32 accumulation; spectral weights and norm statistics stay f32,
and so do the spectral transforms on the FFT path (on the partial-DFT path
they take bf16 operands, ``ops/spectral.py``).

A 2-D ``SpectralConv``, ``PointwiseOp`` or ``OperatorBlock`` also takes a
list of channel pieces in place of one input (a skip concat carried
unconcatenated, ``models/core.py``): each piece is transformed, resampled
and multiplied by its own input rows of the weights, and the products are
summed, which is the concatenated input's result up to rounding.  A 3-D or
1-D conv given pieces concatenates them; a residual block refuses them.

Two forms for a model shared by the ranks of the mesh's ``spatial`` axis
(``uno_tpu_torch/parallel``):

* split: ``forward(..., split=)`` takes this rank's rows of the first grid
  axis (a ``Split``) and returns its rows of ``out_size``; the spectral
  conv, the resample along that axis and the norm's statistics reach the
  other ranks (``parallel/spatial.py``), the channel products do not.
* channel tensor parallel: after ``parallel/tp.py`` ``shard_state_tp`` a
  layer's ``tp`` is set and its parameters hold this rank's shard of their
  out-channel axis.  ``Dense`` computes its out-channel shard and gathers
  the channels; ``SpectralConv`` and ``PointwiseOp`` return their shard;
  ``OperatorBlock`` normalises its shard (instance norm is per channel) and
  gathers the channels after the GELU.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from uno_tpu_torch.ops.norm import instance_norm
from uno_tpu_torch.parallel.spatial import gather_channels
from uno_tpu_torch.ops.resample import resize
from uno_tpu_torch.ops.spectral import (
    fourier_truncate_3d,
    spectral_conv_1d,
    spectral_conv_2d,
    spectral_conv_3d,
    spectral_weight_init,
)


def _uniform(shape, bound: float, generator, device) -> nn.Parameter:
    t = (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound
    return nn.Parameter(t.to(device))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact erf form (torch's F.gelu default), as ``uno_tpu`` uses."""
    return F.gelu(x)


class Dense(nn.Module):
    """Channels-last linear layer with torch nn.Linear default init.

    ``dtype=torch.bfloat16`` runs the matmul in bf16 and emits bf16 (params
    stay f32), as ``uno_tpu``'s Dense does on an accelerator.
    """

    def __init__(self, in_features: int, features: int, dtype=torch.float32,
                 device=None, generator: torch.Generator = None):
        super().__init__()
        self.dtype = dtype
        k = 1.0 / math.sqrt(in_features)
        self.weight = _uniform((features, in_features), k, generator, device)
        self.bias = _uniform((features,), k, generator, device)
        self.tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))
        return y if self.tp is None else gather_channels(y, -1, self.tp)


_SPECTRAL_FNS = {1: spectral_conv_1d, 2: spectral_conv_2d, 3: spectral_conv_3d}
_N_BLOCKS = {1: 1, 2: 2, 3: 4}  # corner blocks of the spectrum: none, kx signs, (kx, ky) signs


class SpectralConv(nn.Module):
    """Truncated-mode Fourier integral operator in 1, 2 or 3 dimensions (one
    entry of ``modes`` each); ``out_size`` at call time sets the output
    grid."""

    def __init__(self, in_codim: int, out_codim: int, modes: Tuple[int, ...],
                 device=None, generator: torch.Generator = None):
        super().__init__()
        self.modes = tuple(modes)
        self.weights = nn.Parameter(spectral_weight_init(
            in_codim, out_codim, self.modes, _N_BLOCKS[len(self.modes)], generator, device))
        self.tp = None

    def forward(self, x, out_size: Tuple[int, ...], split=None) -> torch.Tensor:
        """``x``: a tensor, or in 2-D a list of channel pieces."""
        fn = _SPECTRAL_FNS[len(self.modes)]
        if isinstance(x, list) and len(self.modes) != 2:
            x = torch.cat(x, dim=1)
        if len(self.modes) == 1:
            if split is not None:
                raise NotImplementedError(
                    "a split 1-D spectral conv: uno_tpu has no 1-D model or trainer to split")
            return fn(x, self.weights, out_size[0], self.modes[0])
        return fn(x, self.weights, tuple(out_size), self.modes, split)


class PointwiseOp(nn.Module):
    """1x1 conv (channel mixing) + resampling to ``out_size``, whose length
    is the number of spatial dimensions: linear antialiased in 1-D and
    bicubic antialiased in 2-D (both align_corners=True, as matrix tables:
    torch's interpolate has no 1-D antialias); in 3-D the Fourier truncation (backward
    norm, f32 out) then a trilinear resize (align_corners=True, no
    antialias), the identity once the truncation has set the size."""

    def __init__(self, in_codim: int, out_codim: int, dtype=torch.float32,
                 device=None, generator: torch.Generator = None):
        super().__init__()
        self.in_codim, self.out_codim, self.dtype = in_codim, out_codim, dtype
        k = 1.0 / math.sqrt(in_codim)
        self.weight = _uniform((out_codim, in_codim), k, generator, device)
        self.bias = _uniform((out_codim,), k, generator, device)
        self.tp = None

    def _conv(self, pieces: list) -> torch.Tensor:
        """The channel product of the channel pieces: each against its own
        columns of the weight, the later ones added into the first one's
        product by ``baddbmm``."""
        b, _, *spatial = pieces[0].shape
        k = self.weight.to(self.dtype)  # (out, in), or this rank's out-channel shard
        y, off = None, 0
        for z in pieces:
            c = z.shape[1]
            kz, z = k[:, off : off + c], z.to(self.dtype).reshape(b, c, -1)
            y = torch.matmul(kz, z) if y is None else torch.baddbmm(y, kz.expand(b, -1, -1), z)
            off += c
        return y.reshape(b, k.shape[0], *spatial)

    def _resize(self, z: torch.Tensor, out_size, split=None) -> torch.Tensor:
        if len(out_size) == 1:
            return resize(z, out_size, (2,), "linear", True, True)
        if len(out_size) == 2:
            return resize(z, out_size, (2, 3), "cubic", True, True, split)
        # kept as uno_tpu keeps it; resize skips the axes already at size
        z = fourier_truncate_3d(z, tuple(out_size), split)
        return resize(z, out_size, (2, 3, 4), "linear", True, False,
                      None if split is None else split.at(out_size[0]))

    def forward(self, x, out_size: Tuple[int, ...], split=None) -> torch.Tensor:
        """``x``: a tensor or a list of channel pieces.  ``split``: x holds
        its rows of axis 2 (``parallel/spatial.py``); the FLOP rule below
        reads the global grid and the summed channels, so every rank and
        both forms of the input take the branch an unsplit, concatenated
        call takes."""
        pieces = x if isinstance(x, list) else [x]
        in_grid = pieces[0].shape[2:] if split is None else (split.n, *pieces[0].shape[3:])

        def resize_flops(ch: int) -> float:
            dims = list(in_grid)
            fl = 0.0
            for i, n_out in enumerate(out_size):
                if dims[i] != n_out:
                    others = 1
                    for j, d in enumerate(dims):
                        if j != i:
                            others *= d
                    fl += ch * n_out * dims[i] * others
                    dims[i] = n_out
            return fl

        # Channel mixing and spatial resampling are linear maps on disjoint
        # axes, so they commute: apply the channel matmul on the cheaper side
        # (encoder blocks resize first, decoder blocks conv first), by
        # uno_tpu's FLOP rule.  The resample tables preserve constants, so
        # the bias moves across the resize exactly; under bf16 the order
        # decides where the rounding happens, which is why the rule is kept.
        # In 3-D the truncation's backward norm scales a constant by
        # n_in / n_out, so a bias added after it takes that gain, and one
        # added before it gets it from the truncation.  The dtype flow is
        # uno_tpu's: the resize-first branch ends in the conv's dtype; the
        # conv-first branch ends in the resize's, f32 after a 3-D truncation
        # on the FFT path (the DFT path keeps bf16 through it).
        n_in = math.prod(in_grid)
        n_out = math.prod(out_size)
        conv_first = n_in * self.in_codim * self.out_codim + resize_flops(self.out_codim)
        resize_first = resize_flops(self.in_codim) + n_out * self.in_codim * self.out_codim
        shape = (1, -1) + (1,) * len(out_size)
        if resize_first < conv_first:
            y = self._conv([self._resize(z, out_size, split) for z in pieces])
            bias = self.bias * (n_in / n_out) if len(out_size) == 3 else self.bias
            return y + bias.to(y.dtype).reshape(shape)
        y = self._conv(pieces)
        return self._resize(y + self.bias.to(y.dtype).reshape(shape), out_size, split)


class OperatorBlock(nn.Module):
    """u' = GELU(InstanceNorm(K(u) + W(u))) with both paths resampled to
    ``out_size``.  ``residual`` adds the input after the norm (uno11)."""

    def __init__(self, in_codim: int, out_codim: int, modes: Tuple[int, ...],
                 normalize: bool = False, residual: bool = False,
                 dtype=torch.float32, device=None,
                 generator: torch.Generator = None):
        super().__init__()
        self.normalize, self.residual, self.dtype = normalize, residual, dtype
        self.conv = SpectralConv(in_codim, out_codim, modes, device, generator)
        self.w = PointwiseOp(in_codim, out_codim, dtype, device, generator)
        if normalize:
            self.norm_scale = nn.Parameter(torch.ones(out_codim, device=device))
            self.norm_bias = nn.Parameter(torch.zeros(out_codim, device=device))

    def forward(self, x, out_size: Tuple[int, ...], split=None) -> torch.Tensor:
        """``x``: a tensor or a list of channel pieces (not in a residual
        block)."""
        if self.residual and isinstance(x, list):
            raise ValueError("a residual block cannot take channel pieces")
        # uno_tpu's dtype flow: W is in the compute dtype; the spectral conv
        # is f32 on the FFT path, so under bf16 the sum, norm and GELU run in
        # f32 before the final cast, and bf16 on the DFT path, where they
        # run in bf16 (the norm's statistics in f32)
        out = self.conv(x, out_size, split) + self.w(x, out_size, split)
        if self.normalize:
            out = instance_norm(out, self.norm_scale, self.norm_bias,
                                split=None if split is None else split.at(out_size[0]))
        tp = self.conv.tp  # under TP, out holds this rank's channel shard
        if self.residual:
            res = x if tp is None else x.narrow(1, out.shape[1] * tp.rank, out.shape[1])
            if res.shape != out.shape:
                raise ValueError(
                    f"residual block needs matching shapes, {tuple(x.shape)} vs {tuple(out.shape)}"
                )
            out = out + res
        out = gelu(out).to(self.dtype)
        return out if tp is None else gather_channels(out, 1, tp)
