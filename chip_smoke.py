"""Smoke run of the PyTorch port (uno_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

It drives the port's two paths on the Darcy ``darcy_s211`` preset, model
uno9 at full width (32) on the 211x211 grid, batch 16, under the bf16
mixed-precision policy, with random weights from a seed: serving (batch
inference) and training, on both spectral paths (FFT, the default, and
partial DFT); then the Darcy data generator and checkpoint/resume; then the
same two paths on the NS-2D ``ns2d`` preset, model uno at full width (32) on
the 64x64 grid, batch 16, each sample a 40-step autoregressive rollout
(training: full BPTT, each step rematerialised), and the NS generator;
then the two paths on the NS-3D ``ns3d_t40`` preset, model uno3d_t40 at
full width (8) on the 64x64 grid with T_in = 10 frames in and T_f = 40
out of one 3-D forward, batch 16, on both spectral paths; then the
full-resolution Darcy preset ``darcy_s421``, model uno11 at full width (32)
on the 421x421 grid, batch 4, from a ``.mat`` file that the port's
generator writes on the card, with a zero-shot super-resolution
evaluation; then a 1-D operator block; then every other U-NO variant of
``uno_tpu`` at its published widths (``darcy_s85``, ``ns3d_t20/t10/t9`` and
``ns2d_s256`` through the CLI; ``uno_p``, ``uno_demo`` and the four
``uno3d_*_256`` models, which have no preset, through ``build_model`` and
the trainers).

1. prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, both TF32 flags and cuBLAS's reduced-precision bf16 reduction
   flag (all set off);
2. builds the CUDA kernels from ``uno_tpu_torch/csrc`` (nvcc, sm_90a, one
   process per source);
3. holds each of the five kernels (contraction forward, dx, dw; head
   forward, backward) against its plain PyTorch version on the card at the
   shapes the paths give it, checks that a second launch gives the same
   bits, and times both (median of per-launch CUDA events, the L2 flushed
   before each launch by reading a 256 MB buffer, in turns plain, kernel,
   kernel, plain).  Beside each time: the kernel's bound, the larger of its
   bytes (each input read once, each output written once) at the card's
   3.35 TB/s and its flops at 67 TFLOP/s of f32 outside the tensor cores,
   and the time of one PyTorch call that computes the same function where
   there is one (the contractions' plain versions are one einsum each, so
   that time is also their ``library_ms``; the head has none).  A
   one-element add timed the same way gives the floor of this timing.  The
   spectrum remap kernel the same way at every remap of one darcy_s211
   uno9 training step at batch 16, bf16 (its skips concatenated; its
   forward's alone too) and f32 (its skips as channel pieces);
4. runs ``python -m uno_tpu_torch.cli predict`` over a synthetic six-key
   darcy_s211 split (128 test samples: 8 batches of 16) once to warm up and
   once measured, with the launch counts set to 0 just before the measured
   run; checks the output, that the contraction launched 5 times, the
   spectrum remap 10 times (2 a conv) and the head once per batch and that
   no backward kernel did; prints the median,
   fastest and slowest of the measured run's 8 warm batches;
5. runs ``python -m uno_tpu_torch.cli train`` for 3 epochs of 4 steps on a
   synthetic split (64 train, 16 val, 16 test) with a learnable target, the
   counts set to 0 just before; checks that the losses are finite and fall
   and that every kernel launched as often as the steps and evaluation
   batches require; prints the warm ms per step and the peak device memory;
6. runs the same predict and train on the partial-DFT spectral path
   (``UNO_TPU_TORCH_DFT=1``): the contraction and remap kernels launch 0
   times, the head's as on the FFT path; prints the ms per batch and per warm step of
   both paths from this run side by side (``[dft]``);
7. runs the port's Darcy generator on the card, n = 32 at s = 211 with
   threshold coefficients: its ms, CG iterations and final relative
   residual, the coefficient values (only 4 and 12), and two of its fields
   solved again on the card and on the CPU (``[generate]``);
8. ``cli train --generate`` of a small darcy_s211 split for 2 epochs with
   ``--checkpoint-dir``, ``--resume`` for a third (it must log epoch 2
   first), then ``cli predict --checkpoint-dir``, whose output must equal a
   forward of the restored ``best_params`` (``[checkpoint]``);
9. NS-2D: the five kernels again at ns2d's shapes (``[kernels ns2d]``: the
   seven uno contractions, the (16, 64, 64*64, 128, 1) head, whose backward
   runs its plan of 4 gk1 shares, one block per SM); the NS generator on
   the card, a batch of 20 on the fast profile (25,000 steps) and 200 steps
   from one w0 on the card and the CPU (``[ns-generate]``); ``cli predict
   --preset ns2d`` over 8 batches of 16 trajectories, warm and measured,
   280 contraction and 40 head launches per batch and no backward
   (``[ns-predict]``); ``cli train --preset ns2d --generate`` of a 32/4/4
   split for 3 epochs, validation on epochs 0 and 2, a falling loss, and
   each kernel's launches from the steps and evaluation batches: every
   step's forward runs twice, the checkpoint's recompute included
   (``[ns-train]``: warm ms per step, peak device memory);
10. computes one training loss and all gradients with the same weights on 2
   samples at 211x211 on the card and on the CPU (f32 and bf16) and bounds
   the difference, then does the same for the forward alone, on the FFT path
   and then on the DFT path (``[dft-cuda-vs-cpu]``); then the NS-2D rollout's
   loss, trajectory and gradients at T_f = 2 on 2 samples at 64x64
   (``[ns-cuda-vs-cpu]``);
11. NS-3D: the three contractions at uno3d_t40's seven shapes, batch 16
   (``[kernels ns3d]``; the head is not on this path: a 3-D model projects
   through the unfused f32 Dense pair) and the spectrum remap kernel at each
   of the 42 remaps of one f32 uno3d_t40 training step at batch 16, bit for
   bit against its plain version, timed as the kernels above against its
   bytes (its plain version is no single PyTorch call; the same at
   uno3d_t40_256's 54, batch 4, 256x256, in ``[kernels ns3d-t40-256]``);
   ``cli predict --preset ns3d_t40``
   over 8 batches of 16 input windows, warm and measured, 7 contraction,
   21 remap and no head launches per batch (``[ns3d-predict]``); ``cli train
   --preset ns3d_t40 --generate`` of a 32/4/4 split for 3 epochs of 2
   steps, validation on epochs 0 and 2, 7 / 7 / 7 contractions and 42
   remaps per step and 7 and 21 per evaluation batch, no head launch
   (``[ns3d-train]``: warm ms
   per step, peak device memory); uno3d_t40 at width 4, 2 samples at
   64x64, on the card and the CPU with the same weights: the output, the
   loss and every gradient (``[ns3d-cuda-vs-cpu]``).

12. NS-3D on the partial-DFT path (``UNO_TPU_TORCH_DFT=1``): the same
   predict and train, no contraction launch, both paths' ms per batch and
   per warm step side by side; uno3d_t40's block-0 conv and truncation at
   width 4 on the DFT path, card against CPU, forward and gradients
   (``[dft3d]``);
13. darcy_s421: ``cli generate --task darcy --size 421`` writes 32 samples
   on the card (``[s421-generate]``: ms, CG iterations, residual); ``cli
   train --preset darcy_s421 --data`` of that file, 24/4/4 samples, 3
   epochs of 6 steps, each kernel's launches from its steps and evaluation
   batches (``[s421-train]``: warm ms per step with spread, first step,
   peak device memory); ``cli predict --preset darcy_s421 --data``, 8
   batches of 4, warm and measured, 7 contractions and 1 head per batch
   (``[s421-predict]``); darcy_s211 trained 2 epochs on ``::2`` of the same
   file, then ``evaluate_superres`` of its best params at 211 and 421 on 8
   held-out samples, batch 8 (``[superres]``: both rel-L2s, finite); the
   kernels at uno11's seven shapes and its (4, 64, 421*421, 32, 1) head,
   and the forward kernels at the super-resolution batch of 8 (``[kernels
   s421]``, ``[kernels s421 superres]``); uno11 at width 4 on the card and
   the CPU: output, loss, every gradient, f32 and bf16
   (``[s421-cuda-vs-cpu]``);
14. a 1-D OperatorBlock (1024 -> 512 points, 64 modes) on the card and the
   CPU, forward and every gradient, f32 and bf16, on both spectral paths,
   and the three contractions and the remaps of its f32 forward and
   backward at its shape (``[1d]``, ``[kernels 1d]``);
15. data parallelism (``uno_tpu_torch.parallel``): ``cli train --preset
   darcy_s211 --dtype bfloat16 --data-parallel`` as one NCCL rank
   (``RANK=0 WORLD_SIZE=1``) against the same run without it, losses and
   final weights within rel 1e-6, both ``step_ms`` medians
   (``[dp-nccl]``); two ranks on the one card over gloo (NCCL refuses two
   ranks on one device), started by this script as two processes: darcy_s211
   uno9 in f32, global batch 16 (8 a rank), 2 epochs, against one process
   at batch 16 (train loss per epoch within rel 1e-4, final weights rel-L2
   within 1e-3 per parameter, the ranks' weights equal bit for bit, every
   dw launch at B = 8: ``[dp]``), then ns3d_t40 bf16, global batch 16, one
   epoch of 2 steps on the generated NS-3D split (finite losses within rel
   5e-2 of one process, the ranks' weights equal, each rank's ``step_ms``:
   ``[dp-ns3d]``); the contractions at the ranks' B = 8 (``[kernels dp]``,
   ``[kernels dp ns3d]``);
16. ``cli export`` of darcy_s211 uno9 bf16 at ``--serve-batch 16`` on the
   card, served from a fresh process that imports only
   ``uno_tpu_torch.export``: 8 batches of the predict split, outputs within
   rel 1e-6 of the eager model's, the graph's ``contract`` and
   ``mlp_head_fwd`` nodes and the process's launch counts, the artifact's
   MB and ms per batch beside the eager model's; ns3d_t40's forward and an
   ``ns2d`` rollout step exported and served against eager (``[export]``);
17. ``cli train --profile-dir`` of a short darcy_s211 run: the trace names
   the port's kernels (``[profile]``);
18. ``[predict]`` and ``[ns-train]`` again with every eager forward launch
   routed through the kernels' ``torch.library`` custom ops, then directly
   again, and the host time of one call each way (``[custom-ops]``);
19. ``remat_blocks``: darcy_s211 uno9 bf16 trained one epoch of 4 steps
   with and without it, the same losses and weights (within rel 1e-6),
   each run's launches and peak device memory (``[remat]``); ``cli
   predict`` with ``UNO_TPU_TORCH_NO_FUSED_HEAD=1``: no head launch, the
   predictions within rel-L2 1e-5 of the kernel's (both heads are the f32
   composition of the same bf16 input; they differ in the order of their
   f32 sums only) (``[head-switch]``);
20. the mesh's ``spatial`` axis, in the same two gloo processes as ``[dp]``
   as one 1 x 2 mesh: darcy_s211 uno9 f32 under channel tensor parallelism
   (``[tp]``: every contraction at its Co/2 shard) and split over the
   grid's rows (``[spatial]``: 247 padded rows as 123 + 124, 61 as 30 +
   31), 2 epochs each, against ``[dp]``'s one-process run (train loss per
   epoch within rel 1e-4, final weights within rel-L2 1e-3, the ranks'
   weights bit for bit, each rank's ms per warm step and peak device
   memory); ns3d_t40 bf16 split over X, one epoch of 2 steps, against
   ``[dp-ns3d]``'s one process (``[spatial-ns3d]``); the contractions at
   the TP shard shapes and at the split runs' shapes (``[kernels tp]``,
   ``[kernels spatial]``);
21. the other variants, each at its published widths, bf16, batch 16 (4 at
   256x256), random weights from a seed; for each: the kernels at the
   shapes its factory's spec gives (``[kernels s85]``, ``[kernels
   ns3d-t20]``, ..., ``[kernels ns3d-t9-256]``); a training run of 3 epochs
   (``[...-train]``: a falling loss, ``step_ms``, peak device memory, each
   kernel's launches from the steps and evaluation batches, the head's 0
   but on darcy_s85 and uno_demo, and the contraction shapes the run
   recorded equal to those timed); a few warm batches served host to host
   (``[...-predict]``); darcy_s85 through ``cli train --generate`` and
   ``cli predict``; ns3d_t20, t10 and t9 through ``cli train --data`` of one
   ``cli generate --task ns`` file and ``cli predict``; ns2d_s256 through
   ``cli train`` and ``cli predict`` of a synthetic learnable 256x256
   split; uno_p (``train_ns2d`` and the rollout, on the ns2d phases'
   splits), uno_demo (``train_darcy`` and the forward, on darcy_s211's) and
   the uno3d_*_256 family (``train_ns3d`` and ``forecast`` on synthetic
   256x256 splits); at the end each one's model at full width on 1-2
   samples, card against CPU, f32 and bf16: the forward alone, the loss
   and every gradient (rollouts at T_f = 2; ``[...-cuda-vs-cpu]``);
22. the skip concats as channel pieces (the f32 default of a 2-D model)
   against the materialized form (``UNO_TPU_TORCH_NO_FUSED_SKIPS=1``):
   darcy_s211 uno9, darcy_s421 uno11 and ns2d uno (the 40-step rollout)
   in f32 at their batches, each form's warm serve and step ms in turns,
   peak device memory in training, the kernels a step and a served batch
   in a ``torch.profiler`` trace and the port's kernel launches a step;
   darcy_s211's output and all its gradients in the two forms on the card
   (within 1e-5) and the fused form on the card against the CPU on 2
   samples (1e-4); uno9 bf16's default (materialized) against
   ``UNO_TPU_TORCH_FUSED_SKIPS=1`` (2e-2) (``[fused-skips]``);
   ``ComplexAdam`` on uno9's darcy_s211 parameters on the card, through
   the Adam kernel (``csrc/adam.cu``): 20 steps, the parameters and
   moments within 2 ulp of the plain sequence of torch ops on the card
   given the same gradients, then the kernel's and the plain sequence's
   ms a step (median of 40, L2 flushed) against the bound, the
   optimizer's ms a step (CUDA events, 50 steps), host to host ms, and
   kernels a step counted by the profiler in a fresh process and by the
   kernel's own count (``[adam]``); and
   the run's total seconds (``[total]``).  Every training run above holds
   the Adam kernel's launches to its steps times the launches a step (one
   a 40 parameters), and every serving run to 0.

Any failed phase raises, and the script exits non-zero.  The line before the
last is ``{"kernels": [...]}`` (per kernel the Darcy path's numbers, and
the same keys under ``ns2d``, ``ns3d``, ``s421``, ``superres``, ``1d``,
``dp_nccl``, ``dp``, ``dp_ns3d``, ``export``, ``remat``, ``tp``,
``spatial``, ``spatial_ns3d``, ``s85``, ``ns3d_t20``, ``ns3d_t10``,
``ns3d_t9``, ``s256``, ``uno_p``, ``uno_demo``, ``ns3d_t40_256``,
``ns3d_t20_256``, ``ns3d_t10_256``, ``ns3d_t9_256`` and ``fused_skips``,
the contractions of one f32 darcy_s211 step with the skips as pieces;
``adam_step``, the Adam kernel, is timed at uno9's parameters only;
``remap``, the spectrum remap, is timed at the Darcy path's (and so
``dp_nccl``'s and ``remat``'s), ``export`` (the Darcy forward's),
``fused_skips``, ``1d``, ``ns3d`` and ``ns3d_t40_256``, and has its
launches on every path);
the last line is ``{"ok": true,
"device": {...}}``.  Without a CUDA device it exits 1 and prints no result.

    python3 chip_smoke.py --dp-rank DIR   # one rank of [dp]/[dp-ns3d]/[tp]/[spatial] (started by the script)
    python3 chip_smoke.py --adam-count    # [adam]'s profiler count (started by the script)
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch

from uno_tpu_torch import cli
from uno_tpu_torch.bridge import params_from_flax, params_to_flax
from uno_tpu_torch.configs.presets import get_preset
from uno_tpu_torch.data.darcy_solver import generate_darcy_batch, solve_darcy
from uno_tpu_torch.data.grf import GaussianRF
from uno_tpu_torch.data.loaders import load_darcy
from uno_tpu_torch.data.ns_solver import default_forcing, navier_stokes_2d
from uno_tpu_torch.losses import relative_lp_loss
from uno_tpu_torch.models import LIFT, MODEL_REGISTRY, build_model
from uno_tpu_torch.nn.layers import OperatorBlock
from uno_tpu_torch.ops.kernels import _build
from uno_tpu_torch.ops.kernels import adam as adam_k
from uno_tpu_torch.ops.kernels import cmul as cmul_k
from uno_tpu_torch.ops.kernels import mlp_head as head_k
from uno_tpu_torch.ops.kernels import remap as remap_k
from uno_tpu_torch.ops import spectral
from uno_tpu_torch.ops.spectral import (
    fourier_truncate_3d,
    set_dft_mode,
    spectral_conv_3d,
    spectral_weight_init,
)
from uno_tpu_torch.export import export_forward, load_forward
from uno_tpu_torch.parallel import initialize_from_env, make_mesh
from uno_tpu_torch.parallel.tp import full_state
from uno_tpu_torch.optim import ComplexAdam, _zero_state, step_lr
from uno_tpu_torch.train.checkpoint import CheckpointManager
from uno_tpu_torch.train.common import make_optimizer
from uno_tpu_torch.train.darcy import train_darcy
from uno_tpu_torch.train.evaluate import evaluate_superres
from uno_tpu_torch.train.metrics import MetricLogger
from uno_tpu_torch.train.ns2d import make_rollout, train_ns2d
from uno_tpu_torch.train.ns3d import forecast, train_ns3d

PRESET = "darcy_s211"
S, BATCH, NTEST = 211, 16, 16
NPREDICT = 8 * BATCH  # the predict phase's test split: 8 batches
NTRAIN, NVAL, EPOCHS = 64, 16, 3  # the train phase: 4 steps per epoch
GEN_N, GEN_REL = 32, 1e-4  # the generate phase's batch; card vs CPU bound of its solves
CK_SPLIT = (16, 8, 8)  # the checkpoint phase's generated split: one step per epoch
# (B, Ci, Co, M = 2*m1*m2) of uno9's five spectral contractions at darcy_s211
CMUL_SHAPES = [(16, 32, 64, 648), (16, 64, 128, 128), (16, 128, 128, 128),
               (16, 128, 64, 128), (16, 128, 32, 648)]
# head: B, C (32 from block 4 + 32 from the lift skip), N = 211**2, H, O
HEAD_SHAPE = (16, 64, S * S, 32, 1)
NS_PRESET, NS_S = "ns2d", 64  # uno, width 32, T_in 10, T_f 40, batch 16
NS_PREDICT = 8 * BATCH  # the ns-predict phase's test split: 8 batches of 16 trajectories
NS_SPLIT = (32, 4, 4)  # the ns-train phase's generated split: 2 steps per epoch
NS_GEN_N, NS_GEN_REL, NS_SHORT_STEPS = 20, 1e-4, 200  # ns-generate: a batch; card vs CPU
# (B, Ci, Co, M = 2*m1*m2) of uno's seven spectral contractions at ns2d
NS_CMUL_SHAPES = [(16, 32, 48, 968), (16, 48, 96, 392), (16, 96, 192, 72), (16, 192, 192, 72),
                  (16, 192, 96, 72), (16, 192, 48, 392), (16, 96, 32, 968)]
# head: B, C (32 from block 6 + 32 from the lift skip), N = 64**2, H = 4 * width, O
NS_HEAD_SHAPE = (16, 64, NS_S * NS_S, 128, 1)
NS3D_PRESET = "ns3d_t40"  # uno3d_t40, width 8, pad 3, T_in 10, T_f 40, batch 16
NS3D_PREDICT = 8 * BATCH  # the ns3d-predict phase's test split: 8 batches of 16 windows
NS3D_SPLIT = (32, 4, 4)  # the ns3d-train phase's generated split: 2 steps per epoch
NS3D_CHECK_WIDTH = 4  # ns3d-cuda-vs-cpu: uno3d_t40 at width 4, 2 samples
NS3D_REMAPS = 3 * 7  # remaps of a uno3d_t40 forward, and of its backward: 2 a conv, 1 a truncation
DARCY_REMAPS = 2 * 5  # remaps of a uno9 bf16 forward, and of its backward: 2 a conv
# (B, Ci, Co, M = 2*m1 * 2*m2 * m3) of uno3d_t40's seven spectral contractions at ns3d_t40
NS3D_CMUL_SHAPES = [(16, 8, 16, 6400), (16, 16, 32, 3136), (16, 32, 64, 576),
                    (16, 64, 128, 1008), (16, 128, 32, 1008), (16, 64, 16, 7840),
                    (16, 32, 16, 22400)]
S421_PRESET, S421 = "darcy_s421", 421  # uno11, width 32, pad 12, batch 4
S421_BATCH = get_preset(S421_PRESET).train.batch_size
S421_GEN_N = 32  # the s421-generate phase's .mat: 8 predict batches of 4
S421_SPLIT = (24, 4, 4)  # the s421-train phase: 6 steps per epoch
S421_CHECK_WIDTH = 4  # s421-cuda-vs-cpu: uno11 at width 4, 2 samples at 85x85
# (B, Ci, Co, M = 2*m1*m2) of uno11's seven spectral contractions at darcy_s421
S421_CMUL_SHAPES = [(4, 32, 64, 648), (4, 64, 128, 128), (4, 128, 256, 18), (4, 256, 256, 18),
                    (4, 256, 128, 18), (4, 256, 64, 128), (4, 128, 32, 648)]
# head: B, C (32 from block 6 + 32 from the lift skip), N = 421**2, H, O
S421_HEAD_SHAPE = (S421_BATCH, 64, S421 * S421, 32, 1)
# super-resolution: darcy_s211 (uno9) trained on ::2 of the s421 file, its
# last 8 samples evaluated at 211 and at 421 in one batch of 8 each
SR_SPLIT, SR_BATCH, SR_EPOCHS = (16, 8, 8), 8, 2
SR_CMUL_SHAPES = [(SR_BATCH, ci, co, m) for _, ci, co, m in CMUL_SHAPES]
SR_HEAD_SHAPE = (SR_BATCH, 64, S421 * S421, 32, 1)
# the 1d phase: a 1-D OperatorBlock (B, Ci, Co, N -> out, modes) and its contraction
ONE_D = (16, 32, 64, 1024, 512, 64)
ONE_D_CMUL_SHAPES = [(16, 32, 64, 64)]
DFT3D_CHECK = (2, 4, 8, (64, 64, 13), (48, 48, 13), (20, 20, 4))  # uno3d_t40 block 0, width 4
DP_WORLD, DP_EPOCHS = 2, 2  # [dp]: two ranks on the one card, darcy_s211 f32, 2 epochs
DP_CMUL_SHAPES = [(BATCH // DP_WORLD, ci, co, m) for _, ci, co, m in CMUL_SHAPES]
DP_NS3D_CMUL_SHAPES = [(BATCH // DP_WORLD, ci, co, m) for _, ci, co, m in NS3D_CMUL_SHAPES]
DP_TRAIN_REL, DP_WEIGHT_REL, DP_NS3D_REL = 1e-4, 1e-3, 5e-2  # [dp], [dp-ns3d] bounds
DP_NCCL_REL, EXPORT_REL = 1e-6, 1e-6  # [dp-nccl] against no dp; the served artifact
# [tp]: uno9's five contractions with their out channels halved over 2 ranks
TP_CMUL_SHAPES = [(b, ci, co // DP_WORLD, m) for b, ci, co, m in CMUL_SHAPES]
REMAT_EPOCHS, REMAT_REL = 1, 1e-6  # [remat]: one epoch with and without remat_blocks
EXPORT_NS_REL = 1e-5  # tests/test_export.py's round-trip bound
DFT3D_REL = {"float32": 1e-5, "bfloat16": 2e-2}  # tests/test_torch_cuda.py's DFT bounds
CMUL_ATOL, HEAD_REL = 1e-4, 1e-5          # the CPU tests' bounds
HEAD_GX_REL = 4e-3                         # gx is bf16: one ulp
E2E_REL = {"float32": 1e-4, "bfloat16": 3e-2}
GRAD_REL = {"float32": 1e-4, "bfloat16": 5e-2}
KERNELS = {  # name -> (wrapper module, count key, source, the TPU kernel it replaces)
    "cmul_fwd": (cmul_k, "fwd", "uno_tpu_torch/csrc/cmul.cu", "uno_tpu/ops/pallas/cmul.py:38"),
    "cmul_bwd_x": (cmul_k, "bwd_x", "uno_tpu_torch/csrc/cmul.cu",
                   "uno_tpu/ops/pallas/cmul.py:158"),
    "cmul_bwd_w": (cmul_k, "bwd_w", "uno_tpu_torch/csrc/cmul.cu",
                   "uno_tpu/ops/pallas/cmul.py:162"),
    "mlp_head_fwd": (head_k, "fwd", "uno_tpu_torch/csrc/mlp_head.cu",
                     "uno_tpu/ops/pallas/mlp_head.py:93"),
    "mlp_head_bwd": (head_k, "bwd", "uno_tpu_torch/csrc/mlp_head.cu",
                     "uno_tpu/ops/pallas/mlp_head.py:123"),
    "adam_step": (adam_k, "step", "uno_tpu_torch/csrc/adam.cu", None),  # optax, fused by XLA
    # XLA fuses uno_tpu's slicing and padding of the spectra
    "remap": (remap_k, "remap", "uno_tpu_torch/csrc/spectrum.cu", None),
}
REPS = 20
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM: 3.35 TB/s
F32_FLOPS_PER_MS = 67e9    # H100 SXM: 67 TFLOP/s f32 outside the tensor cores


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-12))


def _adam_per_step(name: str, **kw) -> int:
    """The Adam kernel's launches a training step of factory ``name``'s
    model, one parameter group: one a ``MAX_TENSORS`` of its parameters."""
    n = sum(1 for p in build_model(name, device="meta", **kw).parameters() if p.numel())
    return -(-n // adam_k.MAX_TENSORS)


def _remaps(name: str, dtype: str, sample: tuple, **kw) -> int:
    """The remaps of a forward of factory ``name``'s model on the FFT path,
    and of its backward: those that ``spectral.REMAPS`` counts over one
    forward of a ``sample``-shaped input at batch 1 on the card."""
    model = build_model(name, dtype=dtype, device="cuda", **kw)
    n0 = spectral.REMAPS["forward"]
    with torch.inference_mode():
        model(torch.zeros((1, *sample), device="cuda"))
    return spectral.REMAPS["forward"] - n0


def _zero_launches() -> None:
    for mod, key, _, _ in KERNELS.values():
        mod.LAUNCHES[key] = 0


def _launches() -> dict:
    return {name: mod.LAUNCHES[key] for name, (mod, key, _, _) in KERNELS.items()}


def _time_ms(fn, flush: torch.Tensor, reps: int = REPS) -> list:
    """Per-launch device times in ms.  Before each launch the L2 cache is
    flushed by reading ``flush``: a read leaves clean lines, where a fill
    would leave dirty ones for the timed launch to write back (that made
    the plain versions' times vary up to 1.6x within one run)."""
    events = []
    for _ in range(reps):
        flush.sum()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events]


def _turns(kernel, plain, flush):
    """Median ms of kernel and plain, timed in turns plain, kernel, kernel, plain."""
    p = _time_ms(plain, flush)
    k = _time_ms(kernel, flush) + _time_ms(kernel, flush)
    p += _time_ms(plain, flush)
    return statistics.median(k), statistics.median(p)


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    print(f"allow_tf32: cuda.matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}; allow_bf16_reduced_precision_reduction="
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.BUILD_SECONDS:.1f} s) under {_build.BUILD_DIR}")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("[build]", line.strip())


def _bound(nbytes: float, flops: float) -> tuple:
    """(ms, what bounds it): the larger of bytes over the card's memory rate
    and flops over its f32 rate."""
    tb, tf = nbytes / HBM_BYTES_PER_MS, flops / F32_FLOPS_PER_MS
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _add(res, name, err, km, pm, bound, library):
    r = res.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                                  bytes_ms=0.0, flops_ms=0.0, library_ms=0.0))
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["ms"] += km
    r["plain_ms"] += pm
    r["bound_ms"] += bound[0]
    r["bytes_ms" if bound[1] == "bytes" else "flops_ms"] += bound[0]
    r["library_ms"] = None if library is None else r["library_ms"] + library


def _cmul_case(name, kernel, plain, args, flush, res):
    """One contraction at one shape: error, same bits twice, times, bound."""
    got, again, want = kernel(*args), kernel(*args), plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not err <= CMUL_ATOL:
        raise AssertionError(f"{name}: max abs err {err} > {CMUL_ATOL}")
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two runs on the same inputs differ")
    km, pm = _turns(lambda: kernel(*args), lambda: plain(*args), flush)
    # 8 flops per complex multiply-add; the contracted axis is the first
    # operand's channels (forward, dx) or batch (dw)
    k = args[0].shape[0 if name == "cmul_bwd_w" else 1]
    nbytes = 8 * (args[0].numel() + args[1].numel() + got.numel())
    bound = _bound(nbytes, 8.0 * got.numel() * k)
    _add(res, name, err, km, pm, bound, pm)  # the plain version is one einsum
    return err, km, pm, bound


def phase_kernels(dev, cmul_shapes=CMUL_SHAPES, head_shape=HEAD_SHAPE,
                  tag: str = "kernels", forward_only: bool = False) -> dict:
    """The five kernels at one path's shapes (the three contractions only
    when ``head_shape`` is None; the two forward kernels only when
    ``forward_only``, for a path that serves): errors, bits, times, bounds;
    summed per kernel over the shapes."""
    g = torch.Generator().manual_seed(0)
    flush = torch.ones(256 * 2**20, dtype=torch.uint8, device=dev)  # 5x the 50 MB L2
    res = {}
    crand = lambda *s: torch.complex(torch.randn(*s, generator=g),
                                     torch.randn(*s, generator=g)).to(dev)
    one = torch.zeros(1, device=dev)
    floor = statistics.median(_time_ms(lambda: one.add_(1), flush))
    print(f"[{tag}] timing floor: a one-element add timed the same way takes {floor:.4f} ms")

    for b, ci, co, m in cmul_shapes:
        # activations and cotangents at unit scale, weights from the init
        x, gy = crand(b, ci, m), crand(b, co, m)
        w = spectral_weight_init(ci, co, (m,), 1, g, dev)[0].contiguous()
        cases = [("cmul_fwd", cmul_k.cmul, cmul_k.cmul_plain, (x, w), "complex einsum"),
                 ("cmul_bwd_x", cmul_k.cmul_bwd_x, cmul_k.cmul_bwd_x_plain, (gy, w),
                  "einsum g.conj(w)"),
                 ("cmul_bwd_w", cmul_k.cmul_bwd_w, cmul_k.cmul_bwd_w_plain, (x, gy),
                  "einsum conj(x).g")]
        for name, kernel, plain, args, what in cases[:1] if forward_only else cases:
            err, km, pm, (bd, by) = _cmul_case(name, kernel, plain, args, flush, res)
            print(f"[{tag}] {name} B={b} Ci={ci} Co={co} M={m}: max_abs_err {err:.3g}, "
                  f"same bits twice; kernel {km:.4f} ms  plain = library ({what}) {pm:.4f} ms"
                  f"  bound {bd:.4f} ms ({by})")

    if head_shape is not None:  # None: the path runs no head kernel
        _head_cases(dev, head_shape, g, flush, res, tag, forward_only)
    for name, r in res.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"[{tag}] {name}: kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
              f"library {lib}  bound {r['bound_ms']:.4f} ms (summed over its shapes)")
    for r in res.values():
        r["bound_by"] = "bytes" if r.pop("bytes_ms") >= r.pop("flops_ms") else "operations"
    return res


def phase_remap(dev, forward, what: str, tag: str) -> tuple:
    """The remap kernel at every remap of one training step (``forward()``
    gives its loss, whose backward follows), each launch against the plain
    version on the card: the same bits, times in turns, the bound (the
    destination written and the source elements its maps read, each once,
    at the card's memory rate); summed over the step, and over its forward
    alone: (the step's, the forward's)."""
    calls, launch = [], remap_k.remap

    def spy(src, p):
        calls.append((src, p))
        return launch(src, p)

    remap_k.remap = spy
    try:
        loss = forward()
        n_fwd = len(calls)
        loss.backward()
    finally:
        remap_k.remap = launch
    del loss
    flush = torch.ones(256 * 2**20, dtype=torch.uint8, device=dev)  # 5x the 50 MB L2
    step, fwd = {}, {}
    for i, (src, p) in enumerate(calls):
        got, again = launch(src, p), launch(src, p)
        want = remap_k.remap_plain(src, p)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got, again)):
            raise AssertionError(f"[{tag}] remap {tuple(src.shape)} -> {p.shape}: the kernel "
                                 f"differs from the plain version by "
                                 f"{float((got - want).abs().max())}, or between two runs")
        km, pm = _turns(lambda: launch(src, p),
                        lambda: remap_k.remap_plain(src, p), flush)
        d1, d2, d3 = p.shape
        axes = (p.tab[: 2 * d1], p.tab[2 * d1 : 2 * d1 + 2 * d2],
                p.tab[2 * d1 + 2 * d2 : 2 * d1 + 2 * d2 + d3])
        read = math.prod(len({v for v in a if v >= 0}) for a in axes)
        bound = _bound(8 * (got.numel() + src.shape[0] * src.shape[1] * read), 0.0)
        for res in (step, fwd) if i < n_fwd else (step,):
            _add(res, "remap", 0.0, km, pm, bound, None)
        del got, again, want
    n = len(calls)
    calls.clear()
    s, f = step["remap"], fwd["remap"]
    for r in (s, f):
        r.pop("flops_ms")
        r.pop("bytes_ms")
        r["bound_by"] = "bytes"
    print(f"[{tag}] remap: the {n} launches of a {what} training step, each equal bit for bit to "
          f"the plain version and to itself; step: kernel {s['ms']:.4f} ms  plain "
          f"{s['plain_ms']:.4f} ms  bound {s['bound_ms']:.4f} ms (bytes, summed); its "
          f"{n_fwd} forward launches: kernel {f['ms']:.4f} ms  plain {f['plain_ms']:.4f} ms  "
          f"bound {f['bound_ms']:.4f} ms")
    return s, f


def _forecast_loss(dev, name: str, kw: dict, batch: int, size: int, t_in: int, t_f: int):
    """``phase_remap``'s forward for a uno3d model: the loss of one
    ``forecast`` on random frames."""
    model = build_model(name, device=dev, generator=torch.Generator().manual_seed(0), **kw)
    g = torch.Generator().manual_seed(1)
    xx = torch.randn((batch, size, size, t_in), generator=g).to(dev)
    yy = torch.randn((batch, size, size, t_f), generator=g).to(dev)
    return lambda: relative_lp_loss(forecast(model, xx, t_f), yy)


def _darcy_step_loss(dev, dtype: str):
    """``phase_remap``'s forward for darcy_s211's uno9 in ``dtype`` (bf16:
    its skips concatenated; f32: carried as channel pieces), batch 16."""
    model = build_model("uno9", dtype=dtype, device=dev,
                        generator=torch.Generator().manual_seed(0),
                        **get_preset(PRESET).model_kwargs)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((BATCH, S, S, 1), generator=g).to(dev)
    y = torch.randn((BATCH, S, S), generator=g).to(dev)
    return lambda: _darcy_loss(model, x, y)


def _block_1d_loss(dev):
    """``phase_remap``'s forward for the 1-D OperatorBlock of ``ONE_D``."""
    b, ci, co, n, d, m = ONE_D
    blk = OperatorBlock(ci, co, (m,), normalize=True, device=dev,
                        generator=torch.Generator().manual_seed(0))
    x = torch.randn((b, ci, n), generator=torch.Generator().manual_seed(1)).to(dev)
    x.requires_grad_()
    return lambda: blk(x, (d,)).square().mean()


def _head_cases(dev, head_shape, g, flush, res, tag: str, forward_only: bool = False) -> None:
    """The head's forward and backward kernels (the forward alone when
    ``forward_only``) at one shape: errors, bits, times, bounds."""
    b, c, n, h, o = head_shape
    x = torch.randn(b, c, n, generator=g).to(dev, torch.bfloat16)
    bound = lambda *s: (torch.rand(*s, generator=g) * 2 - 1).to(dev)
    k1, b1 = bound(c, h) / c**0.5, bound(h) / c**0.5
    k2, b2 = bound(h, o) / h**0.5, bound(o) / h**0.5
    got = head_k.mlp_head(x, k1, b1, k2, b2)
    again = head_k.mlp_head(x, k1, b1, k2, b2)
    want = head_k.mlp_head_plain(x, k1, b1, k2, b2)
    torch.cuda.synchronize()
    rel, err = _rel(got, want), float((got - want).abs().max())
    if not rel <= HEAD_REL:
        raise AssertionError(f"mlp_head {head_shape}: rel-L2 {rel} > {HEAD_REL}")
    if not torch.equal(got, again):
        raise AssertionError("mlp_head: two runs on the same inputs differ")
    km, pm = _turns(lambda: head_k.mlp_head(x, k1, b1, k2, b2),
                    lambda: head_k.mlp_head_plain(x, k1, b1, k2, b2), flush)
    wbytes = 4 * (c * h + h + h * o + o)
    # reads bf16 x and the weights, writes f32 out; 2 flops per multiply-add
    bd = _bound(2 * x.numel() + wbytes + 4 * got.numel(), 2.0 * b * n * (c * h + h * o))
    print(f"[{tag}] mlp_head_fwd B={b} C={c} N={n} H={h} O={o}: rel-L2 {rel:.3g} "
          f"max_abs_err {err:.3g}, same bits twice; kernel {km:.4f} ms  plain (unfused "
          f"f32) {pm:.4f} ms  bound {bd[0]:.4f} ms ({bd[1]}); no one-call library version")
    _add(res, "mlp_head_fwd", err, km, pm, bd, None)
    if forward_only:
        return

    gy = torch.randn(b, o, n, generator=g).to(dev)
    args = (x, gy, k1, b1, k2)
    got = head_k.mlp_head_bwd(*args)
    want = head_k.mlp_head_bwd_plain(*args)
    again = head_k.mlp_head_bwd(*args)
    torch.cuda.synchronize()
    rels = [_rel(a, w_) for a, w_ in zip(got, want)]
    err = max(float((a.float() - w_.float()).abs().max()) for a, w_ in zip(got, want))
    if not (rels[0] <= HEAD_GX_REL and max(rels[1:]) <= HEAD_REL):
        raise AssertionError(f"mlp_head_bwd {head_shape}: rel-L2 (gx, gk1, gb1, gk2, gb2) "
                             f"{rels} > ({HEAD_GX_REL}, {HEAD_REL})")
    if not all(torch.equal(a, a2) for a, a2 in zip(got, again)):
        raise AssertionError("mlp_head_bwd: two runs on the same inputs differ")
    km, pm = _turns(lambda: head_k.mlp_head_bwd(*args),
                    lambda: head_k.mlp_head_bwd_plain(*args), flush)
    # reads x, g, k1, b1, k2, writes gx and the four weight gradients; it
    # recomputes z (CH), then dh (HO), gx (CH), gk1 (CH) and gk2 (HO)
    bd = _bound(4 * x.numel() + 4 * gy.numel() + wbytes - 4 * o + wbytes,
                2.0 * b * n * (3 * c * h + 2 * h * o))
    plan = head_k.bwd_plan(b, c, n, h, o, dev.index)
    print(f"[{tag}] mlp_head_bwd B={b} C={c} N={n} H={h} O={o}: rel-L2 gx {rels[0]:.3g} "
          f"weights {max(rels[1:]):.3g}, same bits twice, max_abs_err {err:.3g}; "
          f"kernel {km:.4f} ms  plain (f32 channels-last) {pm:.4f} ms  bound {bd[0]:.4f} ms "
          f"({bd[1]}); no one-call library version; plan: {plan.shares} gk1 shares, "
          f"{plan.smem} B shared memory, {plan.blocks} blocks")
    _add(res, "mlp_head_bwd", err, km, pm, bd, None)


def _write_split(path: str, rng, ntrain: int = 0, nval: int = 0, ntest: int = NTEST) -> None:
    """A six-key darcy_s211 split with the signature uno_tpu's cli writes.
    Test inputs are 3/12 coefficient fields; train and val inputs are
    standard normal with a learnable target, the local average of
    tests/test_train.py."""
    a = np.where(rng.standard_normal((ntest, S, S, 1)) > 0, 12.0, 3.0).astype(np.float32)
    u = (0.01 * rng.standard_normal((ntest, S, S))).astype(np.float32)
    x = rng.standard_normal((ntrain + nval, S, S, 1)).astype(np.float32)
    y = ((x[..., 0] + np.roll(x[..., 0], 1, 1) + np.roll(x[..., 0], 1, 2)) / 3.0)
    y = y.astype(np.float32)
    seed = get_preset(PRESET).train.seed
    sig = f"task=darcy,sub=2,ntrain={ntrain},nval={nval},ntest={ntest},seed={seed}"
    np.savez(path, train_a=x[:ntrain], train_u=y[:ntrain], val_a=x[ntrain:],
             val_u=y[ntrain:], test_a=a, test_u=u, config_sig=np.asarray(sig))


def _run_cli(argv) -> list:
    """Run the CLI, echo its output, return its JSON lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    sys.stdout.write(buf.getvalue())
    if rc != 0:
        raise AssertionError(f"{argv[0]} returned {rc}")
    return [json.loads(l) for l in buf.getvalue().splitlines() if l.startswith("{")]


def _spread(ms: list) -> str:
    return (f"median {statistics.median(ms):.3f} fastest {min(ms):.3f} "
            f"slowest {max(ms):.3f}")


def phase_predict(tmp: str, tag: str = "predict", dft: bool = False) -> list:
    """Serving on one spectral path; returns the measured run's ms per batch."""
    data, out = os.path.join(tmp, "darcy_s211.npz"), os.path.join(tmp, "preds.npz")
    _write_split(data, np.random.default_rng(0), ntest=NPREDICT)
    argv = ["predict", "--preset", PRESET, "--dtype", "bfloat16", "--init-seed", "0",
            "--data-cache", data, "--ntrain", "0", "--nval", "0", "--ntest", str(NPREDICT),
            "--split", "test", "--out", out, "--device", "cuda"]
    warm = _run_cli(argv)[-1]  # first run: cuFFT plans, cuBLAS handles, allocator
    _zero_launches()
    report = _run_cli(argv)[-1]
    launches = _launches()
    ms = report["batch_ms"]
    batches = len(ms)
    pred = np.load(out)["pred"]
    if pred.shape != (NPREDICT, S, S) or not np.isfinite(pred).all():
        raise AssertionError(f"predict output: shape {pred.shape}, finite {np.isfinite(pred).all()}")
    if report["spectral"] != ("dft" if dft else "fft") or report[
            "allow_bf16_reduced_precision_reduction"] or any(report["allow_tf32"].values()):
        raise AssertionError(f"predict ran with {report}")
    if (batches != NPREDICT // BATCH or launches["cmul_fwd"] != (0 if dft else 5 * batches)
            or launches["mlp_head_fwd"] != batches or launches["cmul_bwd_x"]
            or launches["cmul_bwd_w"] or launches["mlp_head_bwd"] or launches["adam_step"]
            or launches["remap"] != (0 if dft else DARCY_REMAPS * batches)):
        raise AssertionError(f"predict kernel launches {launches} over {batches} batches")
    print(f"[{tag}] {PRESET} uno9 bf16 b{BATCH} {report['spectral']} path: {batches} warm "
          f"batches, ms per batch {_spread(ms)} ({[round(v, 3) for v in ms]}; first run "
          f"{[round(v, 3) for v in warm['batch_ms']]}); launches {launches}")
    return ms


def phase_train(tmp: str, dev, tag: str = "train", dft: bool = False) -> tuple:
    """Training on one spectral path; returns (launches, warm ms per step)."""
    data = os.path.join(tmp, "darcy_s211_train.npz")
    _write_split(data, np.random.default_rng(1), NTRAIN, NVAL)
    argv = ["train", "--preset", PRESET, "--dtype", "bfloat16", "--epochs", str(EPOCHS),
            "--device", "cuda", "--data-cache", data, "--ntrain", str(NTRAIN),
            "--nval", str(NVAL), "--ntest", str(NTEST)]
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_launches()
    t0 = time.perf_counter()
    records = _run_cli(argv)
    wall = time.perf_counter() - t0
    launches = _launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    epochs = [r for r in records if "train_rel_l2" in r]
    losses = [r[k] for r in epochs for k in ("train_rel_l2", "val_rel_l2")]
    losses.append(records[-1]["test_rel_l2"])
    if len(epochs) != EPOCHS or not np.isfinite(losses).all():
        raise AssertionError(f"{tag}: {len(epochs)} epochs, losses {losses}")
    if not epochs[-1]["train_rel_l2"] < epochs[0]["train_rel_l2"]:
        raise AssertionError(f"{tag}: loss did not fall: {[r['train_rel_l2'] for r in epochs]}")
    steps = epochs[-1]["step"]
    evals = EPOCHS * -(-NVAL // BATCH) + -(-NTEST // BATCH)  # forward-only batches
    want = {"cmul_fwd": 5 * (steps + evals), "cmul_bwd_x": 5 * steps,
            "cmul_bwd_w": 5 * steps, "mlp_head_fwd": steps + evals, "mlp_head_bwd": steps,
            "adam_step": steps * _adam_per_step("uno9", **get_preset(PRESET).model_kwargs),
            "remap": DARCY_REMAPS * (2 * steps + evals)}
    exact = ("mlp_head_fwd", "mlp_head_bwd", "adam_step", "remap")
    if dft:  # the DFT path contracts with an einsum: no contraction or remap kernel
        want.update(cmul_fwd=0, cmul_bwd_x=0, cmul_bwd_w=0, remap=0)
        exact = tuple(want)
    if any(launches[k] < v if k not in exact else launches[k] != v for k, v in want.items()):
        raise AssertionError(f"{tag} kernel launches {launches}, expected {want} "
                             f"({steps} steps, {evals} eval batches)")
    warm = [ms for r in epochs[1:] for ms in r["step_ms"]]
    path = "dft" if dft else "fft"
    print(f"[{tag}] {PRESET} uno9 bf16 b{BATCH} {path} path: {steps} steps in {EPOCHS} epochs, "
          f"train_rel_l2 {[round(r['train_rel_l2'], 5) for r in epochs]}, "
          f"test_rel_l2 {records[-1]['test_rel_l2']:.5f}; launches {launches}")
    print(f"[{tag}] ms per step: warm median {statistics.median(warm):.3f} "
          f"(epochs 2-{EPOCHS}: {[round(v, 3) for v in warm]}), first step "
          f"{epochs[0]['step_ms'][0]:.1f}; samples/s per epoch "
          f"{[round(r['samples_per_sec'], 1) for r in epochs]}; peak device memory "
          f"{peak_gb:.3f} GB; wall {wall:.1f} s")
    return launches, warm


@contextlib.contextmanager
def _dft_path():
    """The partial-DFT spectral path through the port's environment switch."""
    os.environ["UNO_TPU_TORCH_DFT"] = "1"
    try:
        yield
    finally:
        del os.environ["UNO_TPU_TORCH_DFT"]


def phase_dft(tmp: str, dev, fft_predict_ms: list, fft_train_ms: list) -> None:
    """Serving and training at full width and depth on the partial-DFT path,
    beside the FFT path's numbers from this run."""
    with _dft_path():
        dft_predict_ms = phase_predict(tmp, "dft", dft=True)
        _, dft_train_ms = phase_train(tmp, dev, "dft", dft=True)
    print(f"[dft] serving ms per batch of {BATCH}: dft {_spread(dft_predict_ms)}; "
          f"fft {_spread(fft_predict_ms)}")
    print(f"[dft] training ms per warm step: dft {_spread(dft_train_ms)}; "
          f"fft {_spread(fft_train_ms)}")


def phase_generate(dev) -> None:
    """The port's Darcy generator on the card: n = 32 at s = 211, threshold
    coefficients; two of the coefficient fields solved again on the CPU."""
    generate_darcy_batch(torch.Generator().manual_seed(1), 1, 17, maxiter=2, device=dev)  # warm
    info = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a, p = generate_darcy_batch(torch.Generator().manual_seed(0), GEN_N, S, device=dev,
                                info=info)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    values = sorted(a.unique().tolist())
    if (a.shape != (GEN_N, S, S) or p.shape != a.shape or values != [4.0, 12.0]
            or not torch.isfinite(p).all() or p.abs().max() == 0):
        raise AssertionError(f"generate: shapes {a.shape} {p.shape}, coefficient values "
                             f"{values}, finite {bool(torch.isfinite(p).all())}")
    two_card = solve_darcy(a[:2], torch.ones_like(a[:2]))
    two_cpu = solve_darcy(a[:2].cpu(), torch.ones_like(a[:2]).cpu())
    rel = _rel(two_card, two_cpu)
    if not rel <= GEN_REL:
        raise AssertionError(f"generate: 2 solves card vs CPU rel-L2 {rel} > {GEN_REL}")
    print(f"[generate] darcy n={GEN_N} s={S} threshold on the card: {ms:.1f} ms, "
          f"CG iterations {info['iterations']} (one system for the batch), final relative "
          f"residual {info['residual']:.3g}, coefficient values {values}; 2 of the fields "
          f"solved on card and CPU: rel-L2 {rel:.3g} (bound {GEN_REL})")


def phase_checkpoint(tmp: str, dev) -> None:
    """``cli train --generate`` with checkpoints, ``--resume``, then ``cli
    predict --checkpoint-dir`` against a forward of the restored best params."""
    data, ck = os.path.join(tmp, "generated.npz"), os.path.join(tmp, "ck")
    out = os.path.join(tmp, "ck_preds.npz")
    split = ["--preset", PRESET, "--data-cache", data, "--ntrain", str(CK_SPLIT[0]),
             "--nval", str(CK_SPLIT[1]), "--ntest", str(CK_SPLIT[2]), "--dtype", "bfloat16",
             "--device", "cuda"]
    first = _run_cli(["train", *split, "--generate", "--epochs", "2", "--checkpoint-dir", ck])
    resumed = _run_cli(["train", *split, "--epochs", "3", "--checkpoint-dir", ck, "--resume"])
    epochs = [[r["epoch"] for r in recs if "epoch" in r] for recs in (first, resumed)]
    if epochs != [[0, 1], [2]] or not np.isfinite(resumed[-1]["test_rel_l2"]):
        raise AssertionError(f"checkpoint: epochs {epochs}, last record {resumed[-1]}")
    _run_cli(["predict", *split, "--checkpoint-dir", ck, "--split", "test", "--out", out])
    z = np.load(out)
    model = build_model("uno9", dtype="bfloat16", device=dev,
                        generator=torch.Generator().manual_seed(0),
                        **get_preset(PRESET).model_kwargs)
    model.load_state_dict(CheckpointManager(ck).restore("best_params"))
    model.eval()
    with torch.inference_mode():
        want = torch.cat([model(torch.from_numpy(z["input"][i : i + BATCH]).to(dev)).cpu()
                          for i in range(0, len(z["input"]), BATCH)])[..., 0]
    got = torch.from_numpy(z["pred"])
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"checkpoint: predict --checkpoint-dir differs from the restored "
                             f"best params' forward: max abs {float((got - want).abs().max())}")
    print(f"[checkpoint] train --generate (n={sum(CK_SPLIT)} at s={S}) 2 epochs with "
          f"--checkpoint-dir, --resume logged epochs {epochs[1]} (test_rel_l2 "
          f"{resumed[-1]['test_rel_l2']:.5f}); predict --checkpoint-dir equals the restored "
          f"best_params' forward bit for bit on {len(got)} test samples")


def _grads(model, x, y):
    loss = relative_lp_loss(model(x).reshape(y.shape), y)
    loss.backward()
    flat = torch.cat([torch.view_as_real(p.grad).flatten() if p.is_complex()
                      else p.grad.flatten() for p in model.parameters()])
    return loss.detach(), flat


def phase_grads_cpu_vs_cuda(dev, tag: str = "grads-cuda-vs-cpu") -> None:
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, S, S, 1)).astype(np.float32))
    y = (x[..., 0] + x[..., 0].roll(1, 1) + x[..., 0].roll(1, 2)) / 3.0
    kw = get_preset(PRESET).model_kwargs
    for dtype, bound in GRAD_REL.items():
        cpu = build_model("uno9", dtype=dtype, generator=torch.Generator().manual_seed(0), **kw)
        gpu = build_model("uno9", dtype=dtype, device=dev, **kw)
        params_from_flax(gpu, params_to_flax(cpu))
        want_l, want_g = _grads(cpu, x, y)
        got_l, got_g = _grads(gpu, x.to(dev), y.to(dev))
        rl, rg = _rel(got_l, want_l), _rel(got_g, want_g)
        if not (torch.isfinite(got_g).all() and rl <= bound and rg <= bound):
            raise AssertionError(f"{tag}, {dtype}: loss rel {rl}, "
                                 f"grads rel-L2 {rg} > {bound}")
        print(f"[{tag}] uno9 {S}x{S} b2 {dtype}: loss rel {rl:.3g}, all "
              f"gradients rel-L2 {rg:.3g} (bound {bound})")


def phase_cpu_vs_cuda(dev, tag: str = "cuda-vs-cpu") -> None:
    rng = np.random.default_rng(1)
    x = torch.from_numpy(np.where(rng.standard_normal((2, S, S, 1)) > 0, 12.0, 3.0)
                         .astype(np.float32))
    kw = get_preset(PRESET).model_kwargs
    for dtype, bound in E2E_REL.items():
        cpu = build_model("uno9", dtype=dtype, generator=torch.Generator().manual_seed(0), **kw)
        gpu = build_model("uno9", dtype=dtype, device=dev, **kw)
        params_from_flax(gpu, params_to_flax(cpu))
        with torch.inference_mode():
            want = cpu(x)
            got = gpu(x.to(dev))
        rel = _rel(got, want)
        if not (torch.isfinite(got).all() and rel <= bound):
            raise AssertionError(f"{tag}, {dtype}: rel-L2 {rel} > {bound}")
        print(f"[{tag}] uno9 {S}x{S} b2 {dtype}: rel-L2 {rel:.3g} (bound {bound})")


def _write_ns_split(path: str, rng, ntest: int) -> None:
    """An ns2d test split with the signature uno_tpu's cli writes: inputs
    and targets of unit scale, the vorticity's."""
    a = rng.standard_normal((ntest, NS_S, NS_S, 10)).astype(np.float32)
    u = rng.standard_normal((ntest, NS_S, NS_S, 40)).astype(np.float32)
    preset = dataclasses.replace(get_preset(NS_PRESET), ntrain=0, nval=0, ntest=ntest)
    empty_a, empty_u = a[:0], u[:0]
    np.savez(path, train_a=empty_a, train_u=empty_u, val_a=empty_a, val_u=empty_u,
             test_a=a, test_u=u, config_sig=np.asarray(cli._gen_sig(preset)))


def phase_ns_generate(dev) -> float:
    """The port's NS generator on the card: one batch of 20 at 64x64 on the
    fast profile (dt 1e-3, T = 25: 25,000 steps, 50 frames); then 200 steps
    from the same w0 on the card and on the CPU.  Returns its ms."""
    preset = get_preset(NS_PRESET)
    frames = preset.t_in + preset.t_f
    grf = GaussianRF(2, NS_S, alpha=2.5, tau=7.0)
    f = default_forcing(NS_S, dev)
    navier_stokes_2d(grf.sample(torch.Generator().manual_seed(1), 1, device=dev), f,
                     visc=1e-3, T=2e-3, delta_t=1e-3)  # warm: cuFFT plans
    w0 = grf.sample(torch.Generator().manual_seed(0), NS_GEN_N, device=dev)
    horizon, dt = frames * 0.5, 1e-3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol, sol_t = navier_stokes_2d(w0, f, visc=1e-3, T=horizon, delta_t=dt, record_steps=frames)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    steps = math.ceil(horizon / dt) // frames * frames
    want_t = np.arange(1, frames + 1) * 0.5
    if (sol.shape != (NS_GEN_N, NS_S, NS_S, frames) or not torch.isfinite(sol).all()
            or not np.allclose(sol_t.numpy(), want_t, rtol=1e-6)):
        raise AssertionError(f"ns-generate: shape {tuple(sol.shape)}, finite "
                             f"{bool(torch.isfinite(sol).all())}, sol_t {sol_t.tolist()}")
    short = dict(visc=1e-3, T=NS_SHORT_STEPS * dt, delta_t=dt, record_steps=4)
    card, _ = navier_stokes_2d(w0[:4], f, **short)
    cpu, _ = navier_stokes_2d(w0[:4].cpu(), f.cpu(), **short)
    rel, moved = _rel(card, cpu), _rel(cpu[..., -1], w0[:4].cpu())
    if not rel <= NS_GEN_REL:
        raise AssertionError(f"ns-generate: {NS_SHORT_STEPS} steps card vs CPU rel-L2 {rel} "
                             f"> {NS_GEN_REL}")
    print(f"[ns-generate] navier_stokes_2d n={NS_GEN_N} s={NS_S} on the card, fast profile "
          f"(dt {dt:g}, T {horizon:g}: {steps} steps, {frames} frames): {ms:.1f} ms "
          f"({ms / steps * 1e3:.2f} us per step), sol_t {sol_t[0]:.1f}..{sol_t[-1]:.1f}, "
          f"finite; {NS_SHORT_STEPS} steps from the same w0 (4 fields) on card and CPU: "
          f"rel-L2 {rel:.3g} (bound {NS_GEN_REL}; the field moved {moved:.3g} from w0)")
    return ms


def phase_ns_predict(tmp: str) -> list:
    """``cli predict --preset ns2d``: 8 batches of 16 trajectories, each a
    40-step rollout; returns the measured run's ms per batch."""
    data, out = os.path.join(tmp, "ns2d.npz"), os.path.join(tmp, "ns_preds.npz")
    _write_ns_split(data, np.random.default_rng(3), NS_PREDICT)
    t_f = get_preset(NS_PRESET).t_f
    argv = ["predict", "--preset", NS_PRESET, "--dtype", "bfloat16", "--init-seed", "0",
            "--data-cache", data, "--ntrain", "0", "--nval", "0", "--ntest", str(NS_PREDICT),
            "--split", "test", "--out", out, "--device", "cuda"]
    warm = _run_cli(argv)[-1]
    _zero_launches()
    report = _run_cli(argv)[-1]
    launches = _launches()
    ms = report["batch_ms"]
    batches = len(ms)
    pred = np.load(out)["pred"]
    if pred.shape != (NS_PREDICT, NS_S, NS_S, t_f) or not np.isfinite(pred).all():
        raise AssertionError(f"ns-predict output: shape {pred.shape}, "
                             f"finite {np.isfinite(pred).all()}")
    preset = get_preset(NS_PRESET)
    remaps = _remaps(preset.model, "bfloat16", (NS_S, NS_S, preset.t_in), **preset.model_kwargs)
    if (batches != NS_PREDICT // BATCH or launches["cmul_fwd"] != 7 * t_f * batches
            or launches["mlp_head_fwd"] != t_f * batches
            or launches["remap"] != remaps * t_f * batches
            or launches["cmul_bwd_x"] or launches["cmul_bwd_w"] or launches["mlp_head_bwd"]):
        raise AssertionError(f"ns-predict kernel launches {launches} over {batches} batches")
    print(f"[ns-predict] {NS_PRESET} uno bf16 b{BATCH} T_f={t_f}: {batches} warm batches, ms per "
          f"batch {_spread(ms)} ({[round(v, 3) for v in ms]}; first run "
          f"{[round(v, 3) for v in warm['batch_ms']]}); launches {launches}")
    return ms


def phase_ns_train(tmp: str, dev, tag: str = "ns-train") -> tuple:
    """``cli train --preset ns2d --generate``: a generated 32/4/4 split, 3
    epochs of 2 steps of the 40-step rollout with full BPTT, validation on
    epochs 0 and 2; returns (launches, warm ms per step)."""
    data = os.path.join(tmp, "ns2d_train.npz")
    t_f = get_preset(NS_PRESET).t_f
    ntrain, nval, ntest = NS_SPLIT
    argv = ["train", "--preset", NS_PRESET, "--dtype", "bfloat16", "--epochs", str(EPOCHS),
            "--device", "cuda", "--generate", "--data-cache", data, "--ntrain", str(ntrain),
            "--nval", str(nval), "--ntest", str(ntest)]
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_launches()
    t0 = time.perf_counter()
    records = _run_cli(argv)
    wall = time.perf_counter() - t0
    launches = _launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    epochs = [r for r in records if "train_step_rel_l2" in r]
    evaluated = [r for r in epochs if "val_step_rel_l2" in r]
    losses = [r[k] for r in epochs for k in r if k.endswith("rel_l2")]
    losses += [records[-1]["test_step_rel_l2"], records[-1]["test_traj_rel_l2"]]
    if (len(epochs) != EPOCHS or [r["epoch"] for r in evaluated] != [0, 2]
            or not np.isfinite(losses).all()):
        raise AssertionError(f"{tag}: {len(epochs)} epochs, validated "
                             f"{[r['epoch'] for r in evaluated]}, losses {losses}")
    if not epochs[-1]["train_step_rel_l2"] < epochs[0]["train_step_rel_l2"]:
        raise AssertionError(f"{tag}: loss did not fall: "
                             f"{[r['train_step_rel_l2'] for r in epochs]}")
    steps = epochs[-1]["step"]
    evals = len(evaluated) * -(-nval // BATCH) + -(-ntest // BATCH)  # forward-only batches
    # each training step runs every rollout step's forward twice (the
    # checkpoint's recompute) and its backward once
    preset = get_preset(NS_PRESET)
    want = {"cmul_fwd": 7 * t_f * (2 * steps + evals), "cmul_bwd_x": 7 * t_f * steps,
            "cmul_bwd_w": 7 * t_f * steps, "mlp_head_fwd": t_f * (2 * steps + evals),
            "mlp_head_bwd": t_f * steps,
            "adam_step": steps * _adam_per_step(preset.model, **preset.model_kwargs),
            "remap": _remaps(preset.model, "bfloat16", (NS_S, NS_S, preset.t_in),
                             **preset.model_kwargs) * t_f * (3 * steps + evals)}
    if launches != want:
        raise AssertionError(f"{tag} kernel launches {launches}, expected {want} "
                             f"({steps} steps, {evals} eval batches)")
    warm = [ms for r in epochs[1:] for ms in r["step_ms"]]
    print(f"[{tag}] {NS_PRESET} uno bf16 b{BATCH} T_f={t_f} BPTT: generated {sum(NS_SPLIT)} "
          f"trajectories, {steps} steps in {EPOCHS} epochs, train_step_rel_l2 "
          f"{[round(r['train_step_rel_l2'], 5) for r in epochs]}, val_step_rel_l2 "
          f"{[round(r['val_step_rel_l2'], 5) for r in evaluated]}, test step/traj "
          f"{records[-1]['test_step_rel_l2']:.5f}/{records[-1]['test_traj_rel_l2']:.5f}; "
          f"launches {launches}")
    print(f"[{tag}] ms per step: warm median {statistics.median(warm):.3f} "
          f"(epochs 2-{EPOCHS}: {[round(v, 3) for v in warm]}), first step "
          f"{epochs[0]['step_ms'][0]:.1f}; peak device memory {peak_gb:.3f} GB; wall "
          f"{wall:.1f} s (generation included)")
    return launches, warm


def phase_ns_cuda_vs_cpu(dev) -> None:
    """The 2-step rollout of uno at full width, 2 samples at 64x64, with the
    same weights on the card and the CPU: the trajectory, the loss and all
    gradients (``_card_vs_cpu``)."""
    rng = np.random.default_rng(4)
    xx = torch.from_numpy(rng.standard_normal((2, NS_S, NS_S, 10)).astype(np.float32))
    yy = xx[..., -1:] + 0.1 * torch.from_numpy(
        rng.standard_normal((2, NS_S, NS_S, 2)).astype(np.float32))
    _card_vs_cpu("ns-cuda-vs-cpu", dev, "uno", get_preset(NS_PRESET).model_kwargs, xx, yy,
                 *_rollout_fns(2), True, t_f=2)


def _write_ns3d_split(path: str, rng, ntest: int, name: str = NS3D_PRESET) -> None:
    """An NS-3D preset's test split with the signature uno_tpu's cli writes:
    input windows and targets of unit scale, the vorticity's."""
    preset = get_preset(name, ntrain=0, nval=0, ntest=ntest)
    a = rng.standard_normal((ntest, NS_S, NS_S, preset.t_in)).astype(np.float32)
    u = rng.standard_normal((ntest, NS_S, NS_S, preset.t_f)).astype(np.float32)
    empty_a, empty_u = a[:0], u[:0]
    np.savez(path, train_a=empty_a, train_u=empty_u, val_a=empty_a, val_u=empty_u,
             test_a=a, test_u=u, config_sig=np.asarray(cli._gen_sig(preset)))


def phase_ns3d_predict(tmp: str, tag: str = "ns3d-predict", dft: bool = False) -> list:
    """``cli predict --preset ns3d_t40``: 8 batches of 16 input windows, each
    one 3-D forward to 40 steps, on one spectral path; returns the measured
    run's ms per batch."""
    data, out = os.path.join(tmp, "ns3d.npz"), os.path.join(tmp, "ns3d_preds.npz")
    _write_ns3d_split(data, np.random.default_rng(5), NS3D_PREDICT)
    t_f = get_preset(NS3D_PRESET).t_f
    argv = ["predict", "--preset", NS3D_PRESET, "--dtype", "bfloat16", "--init-seed", "0",
            "--data-cache", data, "--ntrain", "0", "--nval", "0", "--ntest", str(NS3D_PREDICT),
            "--split", "test", "--out", out, "--device", "cuda"]
    warm = _run_cli(argv)[-1]
    _zero_launches()
    report = _run_cli(argv)[-1]
    launches = _launches()
    ms = report["batch_ms"]
    batches = len(ms)
    pred = np.load(out)["pred"]
    if pred.shape != (NS3D_PREDICT, NS_S, NS_S, t_f) or not np.isfinite(pred).all():
        raise AssertionError(f"{tag} output: shape {pred.shape}, "
                             f"finite {np.isfinite(pred).all()}")
    if report["spectral"] != ("dft" if dft else "fft") or report["dtype"] != "bfloat16":
        raise AssertionError(f"{tag} ran with {report}")
    if (batches != NS3D_PREDICT // BATCH or launches["cmul_fwd"] != (0 if dft else 7 * batches)
            or launches["remap"] != (0 if dft else NS3D_REMAPS * batches)
            or launches["mlp_head_fwd"] or launches["mlp_head_bwd"]
            or launches["cmul_bwd_x"] or launches["cmul_bwd_w"]):
        raise AssertionError(f"{tag} kernel launches {launches} over {batches} batches")
    per_batch = {k: v / batches for k, v in launches.items()}
    print(f"[{tag}] {NS3D_PRESET} uno3d_t40 bf16 b{BATCH} T_in=10 -> T_f={t_f} "
          f"{report['spectral']} path: "
          f"{batches} warm batches, ms per batch {_spread(ms)} ({[round(v, 3) for v in ms]}; "
          f"first run {[round(v, 3) for v in warm['batch_ms']]}); launches per batch "
          f"{per_batch}")
    return ms


def phase_ns3d_train(tmp: str, dev, tag: str = "ns3d-train", dft: bool = False) -> tuple:
    """``cli train --preset ns3d_t40 --generate``: a generated 32/4/4 split
    (made once, then read from its cache), 3 epochs of 2 steps on one
    spectral path, validation on epochs 0 and 2; returns (launches, warm ms
    per step)."""
    data = os.path.join(tmp, "ns3d_train.npz")
    ntrain, nval, ntest = NS3D_SPLIT
    argv = ["train", "--preset", NS3D_PRESET, "--dtype", "bfloat16", "--epochs", str(EPOCHS),
            "--device", "cuda", "--generate", "--data-cache", data, "--ntrain", str(ntrain),
            "--nval", str(nval), "--ntest", str(ntest)]
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_launches()
    t0 = time.perf_counter()
    records = _run_cli(argv)
    wall = time.perf_counter() - t0
    launches = _launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    epochs = [r for r in records if "train_step_rel_l2" in r]
    evaluated = [r for r in epochs if "val_step_rel_l2" in r]
    losses = [r[k] for r in epochs for k in r if k.endswith("rel_l2")]
    losses += [records[-1]["test_full_rel_l2"], records[-1]["test_step_rel_l2"]]
    if (len(epochs) != EPOCHS or [r["epoch"] for r in evaluated] != [0, 2]
            or not np.isfinite(losses).all()):
        raise AssertionError(f"{tag}: {len(epochs)} epochs, validated "
                             f"{[r['epoch'] for r in evaluated]}, losses {losses}")
    if not epochs[-1]["train_step_rel_l2"] < epochs[0]["train_step_rel_l2"]:
        raise AssertionError(f"{tag}: loss did not fall: "
                             f"{[r['train_step_rel_l2'] for r in epochs]}")
    steps = epochs[-1]["step"]
    evals = len(evaluated) * -(-nval // BATCH) + -(-ntest // BATCH)  # forward-only batches
    preset = get_preset(NS3D_PRESET)
    want = {"cmul_fwd": 7 * (steps + evals), "cmul_bwd_x": 7 * steps,
            "cmul_bwd_w": 7 * steps, "mlp_head_fwd": 0, "mlp_head_bwd": 0,
            "adam_step": steps * _adam_per_step(preset.model, **preset.model_kwargs),
            "remap": NS3D_REMAPS * (2 * steps + evals)}
    if dft:  # the DFT path contracts with an einsum and slices no spectrum: no kernel
        want.update(cmul_fwd=0, cmul_bwd_x=0, cmul_bwd_w=0, remap=0)
    if launches != want:
        raise AssertionError(f"{tag} kernel launches {launches}, expected {want} "
                             f"({steps} steps, {evals} eval batches)")
    warm = [ms for r in epochs[1:] for ms in r["step_ms"]]
    print(f"[{tag}] {NS3D_PRESET} uno3d_t40 bf16 b{BATCH} {'dft' if dft else 'fft'} path: "
          f"generated {sum(NS3D_SPLIT)} "
          f"trajectories, {steps} steps in {EPOCHS} epochs, train_step_rel_l2 "
          f"{[round(r['train_step_rel_l2'], 5) for r in epochs]}, val_step_rel_l2 "
          f"{[round(r['val_step_rel_l2'], 5) for r in evaluated]}, val_full_rel_l2 "
          f"{[round(r['val_full_rel_l2'], 5) for r in evaluated]}, test full/step "
          f"{records[-1]['test_full_rel_l2']:.5f}/{records[-1]['test_step_rel_l2']:.5f}; "
          f"launches {launches} ({steps} steps, {evals} eval batches)")
    print(f"[{tag}] ms per step: warm median {statistics.median(warm):.3f} "
          f"(epochs 2-{EPOCHS}: {[round(v, 3) for v in warm]}), first step "
          f"{epochs[0]['step_ms'][0]:.1f}; peak device memory {peak_gb:.3f} GB; wall "
          f"{wall:.1f} s (generation included)")
    return launches, warm


def phase_ns3d_cuda_vs_cpu(dev) -> None:
    """uno3d_t40 at width 4, 2 samples at 64x64: the forward, then the loss
    and all gradients, with the same weights on the card and the CPU
    (``_card_vs_cpu``)."""
    p = get_preset(NS3D_PRESET)
    xx, yy = _pair(np.random.default_rng(6), (2, NS_S, NS_S, p.t_in), (2, NS_S, NS_S, p.t_f))
    _card_vs_cpu("ns3d-cuda-vs-cpu", dev, "uno3d_t40", dict(p.model_kwargs, width=NS3D_CHECK_WIDTH),
                 xx, yy, *_forecast_fns(p.t_f), False)


def phase_s421_generate(tmp: str) -> str:
    """``cli generate --task darcy --size 421``: 32 samples on the card, to
    the ``.mat`` file the s421 phases read; returns its path."""
    path = os.path.join(tmp, "darcy_s421.mat")
    rep = _run_cli(["generate", "--task", "darcy", "--out", path, "--n", str(S421_GEN_N),
                    "--size", str(S421), "--seed", "0", "--device", "cuda"])[-1]
    a, u = load_darcy(1, S421_GEN_N, 1, path)[:2]
    values = sorted(np.unique(a).tolist())
    if (a.shape != (S421_GEN_N, S421, S421, 1) or values != [4.0, 12.0]
            or not np.isfinite(u).all() or not np.abs(u).max() > 0):
        raise AssertionError(f"s421-generate: shapes {a.shape} {u.shape}, coefficient values "
                             f"{values}, finite {np.isfinite(u).all()}")
    print(f"[s421-generate] cli generate --task darcy n={S421_GEN_N} s={S421} on the card: "
          f"{rep['ms']:.1f} ms (the host copy included), CG iterations {rep['cg_iterations']} "
          f"(one system for the batch; the cap is 2000, as in uno_tpu), final relative "
          f"residual {rep['residual']:.3g}; coefficient values {values}")
    return path


def phase_s421_train(mat: str, dev) -> tuple:
    """``cli train --preset darcy_s421 --data``: uno11 at full width on the
    421 grid, 24/4/4 samples of the generated file, 3 epochs of 6 steps at
    batch 4; returns (launches, warm ms per step)."""
    ntrain, nval, ntest = S421_SPLIT
    argv = ["train", "--preset", S421_PRESET, "--data", mat, "--ntrain", str(ntrain),
            "--nval", str(nval), "--ntest", str(ntest), "--epochs", str(EPOCHS),
            "--dtype", "bfloat16", "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_launches()
    t0 = time.perf_counter()
    records = _run_cli(argv)
    wall = time.perf_counter() - t0
    launches = _launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    epochs = [r for r in records if "train_rel_l2" in r]
    losses = [r[k] for r in epochs for k in ("train_rel_l2", "val_rel_l2")]
    losses.append(records[-1]["test_rel_l2"])
    if len(epochs) != EPOCHS or not np.isfinite(losses).all():
        raise AssertionError(f"s421-train: {len(epochs)} epochs, losses {losses}")
    if not epochs[-1]["train_rel_l2"] < epochs[0]["train_rel_l2"]:
        raise AssertionError(f"s421-train: loss did not fall: "
                             f"{[r['train_rel_l2'] for r in epochs]}")
    steps = epochs[-1]["step"]
    evals = EPOCHS * -(-nval // S421_BATCH) + -(-ntest // S421_BATCH)  # forward-only batches
    preset = get_preset(S421_PRESET)
    want = {"cmul_fwd": 7 * (steps + evals), "cmul_bwd_x": 7 * steps, "cmul_bwd_w": 7 * steps,
            "mlp_head_fwd": steps + evals, "mlp_head_bwd": steps,
            "adam_step": steps * _adam_per_step(preset.model, **preset.model_kwargs),
            "remap": _remaps(preset.model, "bfloat16", (S421, S421, 1), **preset.model_kwargs)
            * (2 * steps + evals)}
    if launches != want:
        raise AssertionError(f"s421-train kernel launches {launches}, expected {want} "
                             f"({steps} steps, {evals} eval batches)")
    warm = [ms for r in epochs[1:] for ms in r["step_ms"]]
    print(f"[s421-train] {S421_PRESET} uno11 bf16 b{S421_BATCH} fft path, --data of the "
          f"generated file: {steps} steps in {EPOCHS} epochs, train_rel_l2 "
          f"{[round(r['train_rel_l2'], 5) for r in epochs]}, val_rel_l2 "
          f"{[round(r['val_rel_l2'], 5) for r in epochs]}, test_rel_l2 "
          f"{records[-1]['test_rel_l2']:.5f}; launches {launches}")
    print(f"[s421-train] ms per step: warm {_spread(warm)} (epochs 2-{EPOCHS}: "
          f"{[round(v, 3) for v in warm]}), first step {epochs[0]['step_ms'][0]:.1f}; peak "
          f"device memory {peak_gb:.3f} GB; wall {wall:.1f} s (the .mat read included)")
    return launches, warm


def phase_s421_predict(tmp: str, mat: str) -> list:
    """``cli predict --preset darcy_s421 --data``: all 32 generated samples
    as the test split, 8 batches of 4, warm and measured; returns the
    measured run's ms per batch."""
    out = os.path.join(tmp, "s421_preds.npz")
    argv = ["predict", "--preset", S421_PRESET, "--data", mat, "--ntrain", "0", "--nval", "0",
            "--ntest", str(S421_GEN_N), "--dtype", "bfloat16", "--init-seed", "0",
            "--split", "test", "--out", out, "--device", "cuda"]
    warm = _run_cli(argv)[-1]
    _zero_launches()
    report = _run_cli(argv)[-1]
    launches = _launches()
    ms = report["batch_ms"]
    batches = len(ms)
    pred = np.load(out)["pred"]
    if pred.shape != (S421_GEN_N, S421, S421) or not np.isfinite(pred).all():
        raise AssertionError(f"s421-predict output: shape {pred.shape}, "
                             f"finite {np.isfinite(pred).all()}")
    if (report["spectral"] != "fft" or report["dtype"] != "bfloat16"
            or batches != S421_GEN_N // S421_BATCH or launches["cmul_fwd"] != 7 * batches
            or launches["remap"] != 2 * 7 * batches
            or launches["mlp_head_fwd"] != batches or launches["cmul_bwd_x"]
            or launches["cmul_bwd_w"] or launches["mlp_head_bwd"]):
        raise AssertionError(f"s421-predict: {report['spectral']} path, kernel launches "
                             f"{launches} over {batches} batches")
    print(f"[s421-predict] {S421_PRESET} uno11 bf16 b{S421_BATCH}, --data of the generated "
          f"file: {batches} warm batches host to host, ms per batch {_spread(ms)} "
          f"({[round(v, 3) for v in ms]}; first run {[round(v, 3) for v in warm['batch_ms']]}); "
          f"launches {launches}")
    return ms


def phase_superres(tmp: str, dev, mat: str) -> dict:
    """darcy_s211 (uno9) trained on ``::2`` of the s421 file (16/8/8
    samples, 2 epochs), then ``evaluate_superres`` of its best params on
    the last 8 samples at 211 and at 421, one batch of 8 each; returns the
    evaluation's launches.  Two epochs teach little: only finite values are
    asserted."""
    ck = os.path.join(tmp, "sr_ck")
    ntrain, nval, ntest = SR_SPLIT
    records = _run_cli(["train", "--preset", PRESET, "--data", mat, "--ntrain", str(ntrain),
                        "--nval", str(nval), "--ntest", str(ntest), "--epochs", str(SR_EPOCHS),
                        "--dtype", "bfloat16", "--device", "cuda", "--checkpoint-dir", ck])
    _, _, x_lo, y_lo = load_darcy(2, ntrain + nval, ntest, mat)
    _, _, x_hi, y_hi = load_darcy(1, ntrain + nval, ntest, mat)
    if not np.array_equal(x_lo, x_hi[:, ::2, ::2]) or x_lo.shape[1:3] != (S, S):
        raise AssertionError(f"superres: the {S} split is not ::2 of the {S421} one")
    model = build_model("uno9", dtype="bfloat16", device=dev,
                        generator=torch.Generator().manual_seed(0),
                        **get_preset(PRESET).model_kwargs)
    model.load_state_dict(CheckpointManager(ck).restore("best_params"))
    model.eval()
    _zero_launches()
    res = evaluate_superres(model, x_lo, y_lo, x_hi, y_hi, batch_size=SR_BATCH)
    launches = _launches()
    want = {"cmul_fwd": 2 * 5, "cmul_bwd_x": 0, "cmul_bwd_w": 0, "mlp_head_fwd": 2,
            "mlp_head_bwd": 0, "adam_step": 0, "remap": 2 * DARCY_REMAPS}
    if not all(np.isfinite(v) for v in res.values()) or launches != want:
        raise AssertionError(f"superres: {res}, launches {launches}, expected {want}")
    print(f"[superres] {PRESET} uno9 bf16 trained {SR_EPOCHS} epochs on ::2 of the s421 file "
          f"(train_rel_l2 {[round(r['train_rel_l2'], 5) for r in records if 'train_rel_l2' in r]}"
          f"), evaluate_superres on {ntest} held-out samples, batch {SR_BATCH}: rel_l2_train_res "
          f"({S}x{S}) {res['rel_l2_train_res']:.5f}, rel_l2_super_res ({S421}x{S421}) "
          f"{res['rel_l2_super_res']:.5f} (2 epochs: no accuracy asserted); launches {launches}")
    return launches


def phase_s421_cuda_vs_cpu(dev) -> None:
    """uno11 (darcy_s421's model, the residual block included) at width 4,
    2 samples at 85x85: the output, the loss and every gradient with the
    same weights on the card and the CPU (``_card_vs_cpu``)."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 85, 85, 1)).astype(np.float32))
    y = (x[..., 0] + x[..., 0].roll(1, 1) + x[..., 0].roll(1, 2)) / 3.0
    _card_vs_cpu("s421-cuda-vs-cpu", dev, "uno11",
                 dict(get_preset(S421_PRESET).model_kwargs, width=S421_CHECK_WIDTH), x, y,
                 lambda m, x_: m(x_), _darcy_loss, True)


def _spectral_cases(dev, fn, x, params, cot):
    """``fn(x, *params)`` and the gradients of (fn * cot).sum() on the CPU
    and on the card: [(out, grads...)] per device, complex as (re, im)."""
    res = []
    for d in ("cpu", dev):
        leaves = [t.to(d).detach().requires_grad_() for t in (x, *params)]
        y = fn(*leaves)
        (y.float() * cot.to(d)).sum().backward()
        res.append([y.detach()] + [torch.view_as_real(t.grad) if t.is_complex() else t.grad
                                   for t in leaves])
    return res


def phase_dft3d(tmp: str, dev, fft_predict_ms: list, fft_train_ms: list) -> None:
    """ns3d_t40 serving and training on the partial-DFT path, beside the FFT
    path's numbers from this run; then uno3d_t40's block-0 conv and
    truncation at width 4 on the DFT path, card against CPU."""
    with _dft_path():
        dft_predict_ms = phase_ns3d_predict(tmp, "dft3d", dft=True)
        _, dft_train_ms = phase_ns3d_train(tmp, dev, "dft3d", dft=True)
    print(f"[dft3d] {NS3D_PRESET} serving ms per batch of {BATCH}: dft "
          f"{_spread(dft_predict_ms)}; fft {_spread(fft_predict_ms)}")
    print(f"[dft3d] {NS3D_PRESET} training ms per warm step: dft {_spread(dft_train_ms)}; fft "
          f"{_spread(fft_train_ms)}")
    b, ci, co, grid, out_size, modes = DFT3D_CHECK
    g = torch.Generator().manual_seed(8)
    set_dft_mode(True)
    try:
        for dtype in ("float32", "bfloat16"):
            x = torch.randn((b, ci) + grid, generator=g).to(getattr(torch, dtype))
            w = torch.complex(torch.randn((4, ci, co) + modes, generator=g),
                              torch.randn((4, ci, co) + modes, generator=g)) / (2 * ci) ** 0.5
            c0 = _launches()
            conv = _spectral_cases(dev, lambda a, w_: spectral_conv_3d(a, w_, out_size, modes),
                                   x, (w,), torch.randn((b, co) + out_size, generator=g))
            trunc = _spectral_cases(dev, lambda a: fourier_truncate_3d(a, out_size), x, (),
                                    torch.randn((b, ci) + out_size, generator=g))
            rels = [_rel(gt, wt) for gt, wt in zip(conv[1] + trunc[1], conv[0] + trunc[0])]
            bound = DFT3D_REL[dtype]
            if (_launches() != c0 or conv[1][0].dtype != x.dtype
                    or not all(torch.isfinite(t).all() for t in conv[1] + trunc[1])
                    or max(rels) > bound):
                raise AssertionError(f"dft3d card vs CPU, {dtype}: rel-L2 (conv out, gx, gw; "
                                     f"truncation out, gx) {rels} > {bound}, launches "
                                     f"{_launches()} from {c0}")
            print(f"[dft3d] _DFTConv3d {b}x{ci}x{grid} -> {co}x{out_size} modes {modes} and "
                  f"_DFTTruncate3d, {dtype}, card vs CPU: rel-L2 conv out/gx/gw "
                  f"{rels[0]:.3g}/{rels[1]:.3g}/{rels[2]:.3g}, truncation out/gx "
                  f"{rels[3]:.3g}/{rels[4]:.3g} (bound {bound}); no contraction launch")
    finally:
        set_dft_mode(None)


def phase_1d(dev) -> dict:
    """A 1-D OperatorBlock (normalised, 1024 -> 512 points, 64 modes) card
    against CPU, the forward and every gradient, f32 and bf16, on the FFT
    path (one contraction of each use, two remaps each way) and the DFT
    path (none); returns the FFT path's launches."""
    b, ci, co, n, d, m = ONE_D
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((b, ci, n)).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((b, co, d)).astype(np.float32))
    fft_launches = {}
    for dft in (False, True):
        set_dft_mode(dft)
        try:
            for dtype in ("float32", "bfloat16"):
                tdt = getattr(torch, dtype)
                res = []
                c0 = _launches()
                for dv in ("cpu", dev):
                    blk = OperatorBlock(ci, co, (m,), normalize=True, dtype=tdt, device=dv,
                                        generator=torch.Generator().manual_seed(0))
                    xt = x.to(dv, tdt).detach().requires_grad_()
                    y = blk(xt, (d,))
                    (y.float() * cot.to(dv)).sum().backward()
                    names = [k for k, _ in blk.named_parameters()]
                    res.append([y.detach(), xt.grad] + [
                        torch.view_as_real(p.grad) if p.is_complex() else p.grad
                        for p in blk.parameters()])
                moved = {k: v - c0[k] for k, v in _launches().items()}
                want = {k: 0 for k in moved}
                if not dft:
                    want.update(cmul_fwd=1, cmul_bwd_x=1, cmul_bwd_w=1, remap=4)
                    fft_launches = moved
                rels = [_rel(g, w) for g, w in zip(res[1], res[0])]
                # the norm cancels the 1x1 conv's bias: its gradient is
                # rounding, held absolutely against the whole gradient
                total = torch.cat([t.double().flatten().cpu() for t in res[0][2:]]).norm()
                i = 2 + names.index("w.bias")
                rels[i] = float(max(res[1][i].double().norm(), res[0][i].double().norm())
                                / total)
                bound = {"float32": 1e-4, "bfloat16": GRAD_REL["bfloat16"]}[dtype]
                if (moved != want or res[1][0].dtype != tdt or max(rels) > bound
                        or not all(torch.isfinite(t.float()).all() for t in res[1])):
                    raise AssertionError(f"1d, {'dft' if dft else 'fft'} {dtype}: rel-L2 "
                                         f"{rels} > {bound}, launches {moved}, expected {want}")
                print(f"[1d] OperatorBlock {b}x{ci}x{n} -> {co}x{d} modes {m} "
                      f"{'dft' if dft else 'fft'} path {dtype}, card vs CPU: rel-L2 output "
                      f"{rels[0]:.3g}, gx {rels[1]:.3g}, parameter gradients "
                      f"{max(rels[2:]):.3g} (bound {bound}); card launches {moved}")
        finally:
            set_dft_mode(None)
    return fft_launches


class _Records(MetricLogger):
    """Keeps the trainer's records instead of printing them."""

    def __init__(self):
        self.records = []

    def log(self, record):
        self.records.append(record)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _env(**values):
    """Set environment variables for the block, then restore them."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _load_split(path: str) -> tuple:
    with np.load(path) as z:
        return tuple(z[k] for k in cli._SPLIT_KEYS)


def _param_rels(got: dict, want: dict) -> dict:
    """Per-parameter rel-L2 of two state dicts (complex as (re, im))."""
    real = lambda t: torch.view_as_real(t) if t.is_complex() else t  # noqa: E731
    return {k: _rel(real(got[k]), real(want[k])) for k in want}


def _darcy_want(steps: int, evals: int, heads: bool) -> dict:
    """uno9's launches over ``steps`` training steps and ``evals`` forward-only
    batches: 5 contractions a forward, the head and bf16's remaps where
    ``heads`` (f32's remaps, a skip as two pieces, where not), the Adam
    kernel a step."""
    h, kw = int(heads), get_preset(PRESET).model_kwargs
    return {"cmul_fwd": 5 * (steps + evals), "cmul_bwd_x": 5 * steps, "cmul_bwd_w": 5 * steps,
            "mlp_head_fwd": h * (steps + evals), "mlp_head_bwd": h * steps,
            "adam_step": steps * _adam_per_step("uno9", **kw),
            "remap": _remaps("uno9", "bfloat16" if heads else "float32", (S, S, 1), **kw)
            * (2 * steps + evals)}


def phase_dp_nccl(tmp: str) -> dict:
    """``cli train --data-parallel`` as one NCCL rank (RANK=0, WORLD_SIZE=1)
    against the same run without it, on phase_train's split: the same losses
    and final weights; returns the data-parallel run's launches."""
    data = os.path.join(tmp, "darcy_s211_train.npz")
    argv = ["train", "--preset", PRESET, "--dtype", "bfloat16", "--epochs", str(EPOCHS),
            "--device", "cuda", "--data-cache", data, "--ntrain", str(NTRAIN),
            "--nval", str(NVAL), "--ntest", str(NTEST)]
    cks = [os.path.join(tmp, n) for n in ("dp_nccl_plain", "dp_nccl")]
    plain = _run_cli(argv + ["--checkpoint-dir", cks[0]])
    _zero_launches()
    with _env(MASTER_ADDR="localhost", MASTER_PORT=_free_port(), RANK=0, WORLD_SIZE=1,
              LOCAL_RANK=0):
        dp = _run_cli(argv + ["--data-parallel", "--checkpoint-dir", cks[1]])
    launches = _launches()
    if torch.distributed.is_initialized():
        raise AssertionError("dp-nccl: cli train left its process group initialized")
    runs = [[r for r in recs if "train_rel_l2" in r] for recs in (plain, dp)]
    losses = [[r[k] for r in ep for k in ("train_rel_l2", "val_rel_l2")] + [recs[-1]["test_rel_l2"]]
              for ep, recs in zip(runs, (plain, dp))]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses[1], losses[0]))
    states = [CheckpointManager(ck).restore("train_state")["params"] for ck in cks]
    rels = _param_rels(states[1], states[0])
    bitwise = all(torch.equal(states[1][k], states[0][k]) for k in states[0])
    steps = runs[1][-1]["step"]
    want = _darcy_want(steps, EPOCHS * -(-NVAL // BATCH) + -(-NTEST // BATCH), heads=True)
    if (len(losses[1]) != len(losses[0]) or loss_rel > DP_NCCL_REL
            or max(rels.values()) > DP_NCCL_REL or launches != want):
        raise AssertionError(f"dp-nccl: losses {losses}, rel {loss_rel}, weights rel "
                             f"{max(rels.values())} (bound {DP_NCCL_REL}), launches {launches}, "
                             f"expected {want}")
    warm = [[ms for r in ep[1:] for ms in r["step_ms"]] for ep in runs]
    print(f"[dp-nccl] cli train --data-parallel, {PRESET} uno9 bf16 b{BATCH}, one NCCL rank: "
          f"losses per epoch and test max rel {loss_rel:.3g} of the run without it, final "
          f"weights max rel-L2 {max(rels.values()):.3g} (bound {DP_NCCL_REL}; "
          f"{'bit for bit' if bitwise else 'not bit for bit'}); launches {launches}")
    print(f"[dp-nccl] ms per warm step: data-parallel {_spread(warm[1])}; without "
          f"{_spread(warm[0])}")
    return launches


@contextlib.contextmanager
def _record_shapes():
    """Count each contraction call by (use, B, Ci, Co, M) inside the block
    (the autograd function and the forward call these module globals,
    restored after it)."""
    shapes = Counter()
    fwd, bwd_x, bwd_w = cmul_k._cmul_fwd, cmul_k.cmul_bwd_x, cmul_k.cmul_bwd_w

    def rec_fwd(x, w):
        shapes["cmul_fwd", x.shape[0], w.shape[0], w.shape[1], x.shape[2]] += 1
        return fwd(x, w)

    def rec_bwd_x(g, w):
        shapes["cmul_bwd_x", g.shape[0], w.shape[0], w.shape[1], g.shape[2]] += 1
        return bwd_x(g, w)

    def rec_bwd_w(x, g):
        shapes["cmul_bwd_w", x.shape[0], x.shape[1], g.shape[1], x.shape[2]] += 1
        return bwd_w(x, g)

    cmul_k._cmul_fwd, cmul_k.cmul_bwd_x, cmul_k.cmul_bwd_w = rec_fwd, rec_bwd_x, rec_bwd_w
    try:
        yield shapes
    finally:
        cmul_k._cmul_fwd, cmul_k.cmul_bwd_x, cmul_k.cmul_bwd_w = fwd, bwd_x, bwd_w


# the mesh runs of dp_rank_main: (key, split file, preset, epochs, dtype, mesh, TP)
MESH_RUNS = (("darcy", "darcy", PRESET, DP_EPOCHS, "float32", "data", False),
             ("ns3d", "ns3d", NS3D_PRESET, 1, "bfloat16", "data", False),
             ("tp", "darcy", PRESET, DP_EPOCHS, "float32", "spatial", True),
             ("spatial", "darcy", PRESET, DP_EPOCHS, "float32", "spatial", False),
             ("spatial_ns3d", "ns3d", NS3D_PRESET, 1, "bfloat16", "spatial", False))


def dp_rank_main(out_dir: str, darcy_path: str, ns3d_path: str) -> int:
    """One rank of ``[dp]``, ``[dp-ns3d]``, ``[tp]``, ``[spatial]`` and
    ``[spatial-ns3d]``, started by ``phase_dp``: ``MESH_RUNS`` in order, the
    first two on a 2 x 1 (data) mesh, the others on a 1 x 2 (spatial) mesh,
    each at global batch 16 on cuda:0, over gloo (NCCL refuses two ranks on
    one device; gloo stages the card's tensors through the host).  Saves
    each run's records, launches, contraction shapes, step_ms, peak device
    memory and final weights (whole)."""
    cli._no_tf32()
    _build.library()
    if not initialize_from_env("gloo"):
        raise SystemExit("--dp-rank needs MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK")
    meshes = {"data": make_mesh(device="cuda:0"),
              "spatial": make_mesh(n_data=1, n_spatial=DP_WORLD, device="cuda:0")}
    paths = {"darcy": darcy_path, "ns3d": ns3d_path}
    res = {}
    for key, split, name, epochs, dtype, mesh, tp in MESH_RUNS:
        dp = meshes[mesh]
        preset = get_preset(name)
        model = build_model(preset.model, dtype=dtype, device=dp.device,
                            generator=torch.Generator().manual_seed(0), **preset.model_kwargs)
        cfg = dataclasses.replace(preset.train, epochs=epochs, tensor_parallel=tp)
        rec = _Records()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        with _record_shapes() as shapes:
            if split == "darcy":
                out = train_darcy(model, *_load_split(paths[split]), cfg, logger=rec, dp=dp)
            else:
                out = train_ns3d(model, *_load_split(paths[split]), cfg, t_f=preset.t_f,
                                 logger=rec, dp=dp)
        torch.cuda.synchronize()
        res[key] = dict(records=rec.records, launches=_launches(), shapes=dict(shapes),
                        step_ms=out["step_ms"], peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                        state={k: v.cpu() for k, v in
                               full_state(model, dp, model.state_dict()).items()})
    torch.save(res, os.path.join(out_dir, f"rank{torch.distributed.get_rank()}.pt"))
    torch.distributed.destroy_process_group()
    return 0


def _check_mesh_run(tag, task, ranks, ref, want_launches, want_shapes, bounds):
    """A mesh run's rank 0 against one process: the per-epoch losses
    (``bounds[0]``), the final weights (``bounds[1]``, None: not held), the
    ranks' weights bit for bit, launches and contraction shapes; prints it
    and each rank's ms and peak memory."""
    r0, r1 = ranks[0][task], ranks[1][task]
    if r1["records"] or not all(torch.equal(r0["state"][k], r1["state"][k])
                                for k in r0["state"]):
        raise AssertionError(f"[{tag}]: rank 1 logged {len(r1['records'])} records, or the "
                             "ranks' weights differ")
    key = "train_rel_l2" if task in ("darcy", "tp", "spatial") else "train_step_rel_l2"
    got = [r[key] for r in r0["records"] if key in r]
    want = [r[key] for r in ref["records"] if key in r]
    finite = all(np.isfinite(v) for r in r0["records"] for v in r.values()
                 if isinstance(v, float))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    rels = _param_rels(r0["state"], ref["state"])
    weight_rel = max(rels.values())
    if (len(got) != len(want) or not got or not finite or loss_rel > bounds[0]
            or (bounds[1] is not None and weight_rel > bounds[1])
            or r0["launches"] != want_launches or r0["shapes"] != want_shapes):
        raise AssertionError(f"[{tag}]: {key} {got} against {want} (rel {loss_rel}, bound "
                             f"{bounds[0]}), finite {finite}, weights max rel-L2 {weight_rel} "
                             f"(bound {bounds[1]}), launches {r0['launches']} (expected "
                             f"{want_launches}), shapes {r0['shapes']} (expected {want_shapes})")
    print(f"[{tag}] {key} {[round(v, 6) for v in got]} against one process's "
          f"{[round(v, 6) for v in want]} (max rel {loss_rel:.3g}, bound {bounds[0]}); final "
          f"weights max rel-L2 {weight_rel:.3g} (bound {bounds[1]}); the ranks' weights equal "
          f"bit for bit; rank 0 launches {r0['launches']}; contraction shapes "
          f"{sorted(set(k[1:] for k in r0['shapes']))}")
    for r, rk in enumerate(ranks):
        warm = [ms for ep in rk[task]["step_ms"][1:] for ms in ep] or rk[task]["step_ms"][0]
        print(f"[{tag}] rank {r} ms per warm step (two processes sharing one card): "
              f"{_spread(warm)}; peak device memory {rk[task]['peak_gb']:.3f} GB")
    warm = [ms for ep in ref["step_ms"][1:] for ms in ep] or ref["step_ms"][0]
    print(f"[{tag}] one process: ms per warm step {_spread(warm)}; peak device memory "
          f"{ref['peak_gb']:.3f} GB")
    return r0["launches"]


def _shapes(cmul_shapes, forwards: int, backwards: int) -> dict:
    """Contraction launches by (use, B, Ci, Co, M): each shape once a
    forward, and once per backward for dx and dw."""
    out = {}
    for b, ci, co, m in cmul_shapes:
        out["cmul_fwd", b, ci, co, m] = forwards
        if backwards:
            out["cmul_bwd_x", b, ci, co, m] = out["cmul_bwd_w", b, ci, co, m] = backwards
    return out


def phase_dp(tmp: str, dev) -> tuple:
    """Two ranks on the one card (``dp_rank_main``, two processes), then the
    same trainings in this process at batch 16; returns rank 0's launches
    of each mesh run."""
    out_dir = os.path.join(tmp, "dp")
    os.makedirs(out_dir)
    darcy = os.path.join(tmp, "dp_split.npz")
    _write_split(darcy, np.random.default_rng(11), NTRAIN, NVAL)
    ns3d = os.path.join(tmp, "ns3d_train.npz")  # phase_ns3d_train's generated split
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(DP_WORLD), LOCAL_RANK="0")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-rank", out_dir,
                               darcy, ns3d], env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(DP_WORLD)]
    try:
        logs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"[dp] rank {r} exited {p.returncode}:\n{log[-6000:]}")
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(DP_WORLD)]

    # the same trainings in one process at batch 16
    ref = {}
    for task, path, name, epochs, dtype in (("darcy", darcy, PRESET, DP_EPOCHS, "float32"),
                                             ("ns3d", ns3d, NS3D_PRESET, 1, "bfloat16")):
        preset = get_preset(name)
        model = build_model(preset.model, dtype=dtype, device=dev,
                            generator=torch.Generator().manual_seed(0), **preset.model_kwargs)
        cfg = dataclasses.replace(preset.train, epochs=epochs)
        rec = _Records()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        if task == "darcy":
            out = train_darcy(model, *_load_split(path), cfg, logger=rec)
        else:
            out = train_ns3d(model, *_load_split(path), cfg, t_f=preset.t_f, logger=rec)
        torch.cuda.synchronize()
        ref[task] = dict(records=rec.records, step_ms=out["step_ms"],
                         peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                         state={k: v.cpu() for k, v in model.state_dict().items()})

    print(f"[dp] {PRESET} uno9 f32, 2 ranks on one card over gloo, global batch {BATCH} "
          f"({BATCH // DP_WORLD} a rank), {DP_EPOCHS} epochs of {NTRAIN // BATCH} steps, then "
          f"ns3d_t40, TP and the split runs in the same processes: wall {wall:.1f} s for both "
          f"ranks (start-up included)")
    steps = DP_EPOCHS * (NTRAIN // BATCH)
    evals = DP_EPOCHS * (NVAL // BATCH) + NTEST // BATCH
    darcy_want = _darcy_want(steps, evals, heads=False)
    launches = {"dp": _check_mesh_run(
        "dp", "darcy", ranks, ref["darcy"], darcy_want,
        _shapes(DP_CMUL_SHAPES, steps + evals, steps), (DP_TRAIN_REL, DP_WEIGHT_REL))}
    val = [[r["val_rel_l2"] for r in recs if "val_rel_l2" in r]
           for recs in (ranks[0]["darcy"]["records"], ref["darcy"]["records"])]
    print(f"[dp] val {[round(v, 6) for v in val[0]]} against {[round(v, 6) for v in val[1]]}")
    ns_steps = NS3D_SPLIT[0] // BATCH
    ns_preset = get_preset(NS3D_PRESET)
    ns_want = {"cmul_fwd": 7 * ns_steps, "cmul_bwd_x": 7 * ns_steps,
               "cmul_bwd_w": 7 * ns_steps, "mlp_head_fwd": 0, "mlp_head_bwd": 0,
               "adam_step": ns_steps * _adam_per_step(ns_preset.model,
                                                      **ns_preset.model_kwargs)}
    # val and test splits of 4 under the batch of 16 evaluate nothing (0.0, as
    # under uno_tpu's mesh); the bf16 step loss within rel 5e-2 of one process
    launches["dp_ns3d"] = _check_mesh_run(
        "dp-ns3d", "ns3d", ranks, ref["ns3d"], dict(ns_want, remap=2 * NS3D_REMAPS * ns_steps),
        _shapes(DP_NS3D_CMUL_SHAPES, ns_steps, ns_steps), (DP_NS3D_REL, None))
    launches["tp"] = _check_mesh_run(
        "tp", "tp", ranks, ref["darcy"], darcy_want,
        _shapes(TP_CMUL_SHAPES, steps + evals, steps), (DP_TRAIN_REL, DP_WEIGHT_REL))
    # split: every rank contracts the whole reduced modes, at batch 16; the
    # split axis goes through a partial DFT: no remap
    launches["spatial"] = _check_mesh_run(
        "spatial", "spatial", ranks, ref["darcy"], dict(darcy_want, remap=0),
        _shapes(CMUL_SHAPES, steps + evals, steps), (DP_TRAIN_REL, DP_WEIGHT_REL))
    # the split path transforms the split axis by a partial DFT: no remap
    launches["spatial_ns3d"] = _check_mesh_run(
        "spatial-ns3d", "spatial_ns3d", ranks, ref["ns3d"], dict(ns_want, remap=0),
        _shapes(NS3D_CMUL_SHAPES, ns_steps, ns_steps), (DP_NS3D_REL, None))
    return launches


def phase_remat(tmp: str, dev) -> dict:
    """darcy_s211 uno9 bf16, one epoch of phase_train's split with and
    without ``remat_blocks``: the same losses and weights, each run's
    launches and peak memory; returns the remat run's launches."""
    preset = get_preset(PRESET)
    split = _load_split(os.path.join(tmp, "darcy_s211_train.npz"))
    runs = {}
    for remat in (False, True):
        model = build_model(preset.model, dtype="bfloat16", remat_blocks=remat, device=dev,
                            generator=torch.Generator().manual_seed(0), **preset.model_kwargs)
        rec = _Records()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_launches()
        out = train_darcy(model, *split, dataclasses.replace(preset.train, epochs=REMAT_EPOCHS),
                          logger=rec)
        torch.cuda.synchronize()
        runs[remat] = dict(records=rec.records, launches=_launches(), step_ms=out["step_ms"],
                           peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                           state={k: v.cpu() for k, v in model.state_dict().items()})
    keys = ("train_rel_l2", "val_rel_l2", "test_rel_l2")
    losses = [[r[k] for r in runs[m]["records"] for k in keys if k in r] for m in (False, True)]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    rels = _param_rels(runs[True]["state"], runs[False]["state"])
    bitwise = losses[0] == losses[1] and all(
        torch.equal(runs[True]["state"][k], runs[False]["state"][k]) for k in rels)
    steps = REMAT_EPOCHS * (NTRAIN // BATCH)
    evals = REMAT_EPOCHS * (NVAL // BATCH) + NTEST // BATCH
    want = _darcy_want(steps, evals, heads=True)
    # the recompute runs each block's forward once more in the backward
    want_remat = dict(want, cmul_fwd=want["cmul_fwd"] + 5 * steps,
                      remap=want["remap"] + DARCY_REMAPS * steps)
    if (len(losses[0]) != len(losses[1]) or not losses[0] or loss_rel > REMAT_REL
            or max(rels.values()) > REMAT_REL or runs[False]["launches"] != want
            or runs[True]["launches"] != want_remat):
        raise AssertionError(f"[remat]: losses {losses} (rel {loss_rel}), weights rel "
                             f"{max(rels.values())} (bound {REMAT_REL}), launches "
                             f"{runs[False]['launches']} / {runs[True]['launches']}, expected "
                             f"{want} / {want_remat}")
    print(f"[remat] {PRESET} uno9 bf16 b{BATCH}, {steps} steps with and without remat_blocks: "
          f"losses max rel {loss_rel:.3g}, weights max rel-L2 {max(rels.values()):.3g} (bound "
          f"{REMAT_REL}; {'bit for bit' if bitwise else 'not bit for bit'}); launches without "
          f"{runs[False]['launches']}, with {runs[True]['launches']}")
    for m in (False, True):
        ms = [v for ep in runs[m]["step_ms"] for v in ep][1:]
        print(f"[remat] remat_blocks={m}: peak device memory {runs[m]['peak_gb']:.3f} GB; ms "
              f"per step after the first {_spread(ms)}")
    return runs[True]["launches"]


def phase_head_switch(tmp: str) -> None:
    """``cli predict`` with ``UNO_TPU_TORCH_NO_FUSED_HEAD=1`` on phase_predict's
    split: no head launch, and the predictions against the kernel's."""
    data = os.path.join(tmp, "darcy_s211.npz")
    outs = [os.path.join(tmp, n) for n in ("preds.npz", "preds_no_head.npz")]
    argv = ["predict", "--preset", PRESET, "--dtype", "bfloat16", "--init-seed", "0",
            "--data-cache", data, "--ntrain", "0", "--nval", "0", "--ntest", str(NPREDICT),
            "--split", "test", "--device", "cuda"]
    with _env(UNO_TPU_TORCH_NO_FUSED_HEAD=1):
        _zero_launches()
        report = _run_cli(argv + ["--out", outs[1]])[-1]
        launches = _launches()
    kernel, unfused = (np.load(o)["pred"] for o in outs)
    batches = len(report["batch_ms"])
    rel = float(np.linalg.norm(unfused - kernel) / np.linalg.norm(kernel))
    want = {"cmul_fwd": 5 * batches, "cmul_bwd_x": 0, "cmul_bwd_w": 0, "mlp_head_fwd": 0,
            "mlp_head_bwd": 0, "adam_step": 0, "remap": DARCY_REMAPS * batches}
    if report["fused_head"] or launches != want or not rel <= HEAD_REL:
        raise AssertionError(f"[head-switch]: fused_head {report['fused_head']}, launches "
                             f"{launches} (expected {want}), rel-L2 {rel} (bound {HEAD_REL})")
    print(f"[head-switch] cli predict {PRESET} uno9 bf16 with UNO_TPU_TORCH_NO_FUSED_HEAD=1: "
          f"launches {launches}; predictions rel-L2 {rel:.3g} of the kernel's (bound {HEAD_REL}: "
          f"both heads are f32 sums of the same bf16 input, in another order); ms per batch "
          f"{_spread(report['batch_ms'])}")


_SERVE_CODE = r"""
import json, sys, time
import numpy as np
import torch
from uno_tpu_torch.export import load_forward
from uno_tpu_torch.ops.kernels import adam, cmul, mlp_head, remap

path, xs_path, out_path, batch = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
fn = load_forward(path)
nodes = {}
for n in fn.graph.nodes:
    if str(n.target).startswith("uno_tpu_torch."):
        nodes[str(n.target)] = nodes.get(str(n.target), 0) + 1
xs = np.load(xs_path)
dev = torch.device("cuda", 0)
with torch.inference_mode():
    fn(torch.from_numpy(xs[:batch]).to(dev)).cpu()  # warm: cuFFT plans, allocator
    for counts in (cmul.LAUNCHES, mlp_head.LAUNCHES, adam.LAUNCHES, remap.LAUNCHES):
        for k in counts:
            counts[k] = 0
    ms, outs = [], []
    for i in range(0, len(xs), batch):
        t0 = time.perf_counter()
        outs.append(fn(torch.from_numpy(xs[i:i + batch]).to(dev)).cpu().numpy())
        ms.append((time.perf_counter() - t0) * 1e3)
np.save(out_path, np.concatenate(outs))
mods = sorted(m for m in sys.modules if m.startswith((
    "uno_tpu_torch.models", "uno_tpu_torch.nn", "uno_tpu_torch.ops.spectral",
    "uno_tpu_torch.train", "jax", "flax", "uno_tpu.")))
print(json.dumps({"ms": ms, "nodes": nodes, "modules": mods, "launches": {
    **{"cmul_" + k: v for k, v in cmul.LAUNCHES.items()},
    **{"mlp_head_" + k: v for k, v in mlp_head.LAUNCHES.items()},
    **{"adam_" + k: v for k, v in adam.LAUNCHES.items()}, **remap.LAUNCHES}}))
"""
CONTRACT_OP, HEAD_OP = "uno_tpu_torch.contract.default", "uno_tpu_torch.mlp_head_fwd.default"
REMAP_OP = "uno_tpu_torch.remap.default"


def phase_export(tmp: str, dev) -> dict:
    """``cli export`` of darcy_s211 uno9 bf16 at batch 16, served by a fresh
    process that imports only ``uno_tpu_torch.export``; then ns3d_t40's
    forward and an ns2d rollout step exported and served in this process.
    Returns the serving process's launches."""
    art, xs_path, out_path = (os.path.join(tmp, n) for n in ("uno9.pt2", "xs.npy", "ys.npy"))
    t0 = time.perf_counter()
    report = _run_cli(["export", "--preset", PRESET, "--dtype", "bfloat16", "--init-seed", "0",
                       "--serve-batch", str(BATCH), "--out", art, "--device", "cuda"])[-1]
    export_s = time.perf_counter() - t0
    with np.load(os.path.join(tmp, "darcy_s211.npz")) as z:  # phase_predict's test split
        xs = z["test_a"]
    np.save(xs_path, xs)
    proc = subprocess.run([sys.executable, "-c", _SERVE_CODE, art, xs_path, out_path,
                           str(BATCH)], capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"export: the serving process exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    served = json.loads(proc.stdout.strip().splitlines()[-1])
    got = torch.from_numpy(np.load(out_path))

    model = build_model("uno9", dtype="bfloat16", device=dev,
                        generator=torch.Generator().manual_seed(0),
                        **get_preset(PRESET).model_kwargs).eval()
    eager_ms, outs = [], []
    with torch.inference_mode():
        model(torch.from_numpy(xs[:BATCH]).to(dev)).cpu()
        for i in range(0, len(xs), BATCH):
            t1 = time.perf_counter()
            outs.append(model(torch.from_numpy(xs[i : i + BATCH]).to(dev)).cpu())
            eager_ms.append((time.perf_counter() - t1) * 1e3)
    rel = _rel(got, torch.cat(outs))
    batches = len(xs) // BATCH
    launches = served["launches"]
    want = {"cmul_fwd": 5 * batches, "cmul_bwd_x": 0, "cmul_bwd_w": 0,
            "mlp_head_fwd": batches, "mlp_head_bwd": 0, "adam_step": 0,
            "remap": DARCY_REMAPS * batches}
    if (rel > EXPORT_REL or served["nodes"] != {CONTRACT_OP: 5, HEAD_OP: 1,
                                                 REMAP_OP: DARCY_REMAPS}
            or launches != want or served["modules"] or len(served["ms"]) != batches):
        raise AssertionError(f"export: rel-L2 {rel} (bound {EXPORT_REL}), nodes "
                             f"{served['nodes']}, launches {launches} (expected {want}), model "
                             f"modules imported {served['modules']}")
    print(f"[export] cli export {PRESET} uno9 bf16 --serve-batch {BATCH}: "
          f"{report['bytes'] / 1e6:.1f} MB in {export_s:.1f} s; graph nodes {served['nodes']}; "
          f"a fresh process importing only uno_tpu_torch.export served {batches} batches, "
          f"launches {launches}, no model-building module imported; output rel-L2 {rel:.3g} "
          f"against the eager model (bound {EXPORT_REL})")
    print(f"[export] ms per batch of {BATCH}, host to host: exported {_spread(served['ms'])}; "
          f"eager {_spread(eager_ms)}")

    g = torch.Generator().manual_seed(12)
    # (preset, input, custom-op nodes, remap launches of the served and the eager forward)
    for name, shape, nodes, remaps in (
            (NS3D_PRESET, (BATCH, NS_S, NS_S, 10, 1), {CONTRACT_OP: 7, REMAP_OP: NS3D_REMAPS},
             2 * NS3D_REMAPS),
            (NS_PRESET, (BATCH, NS_S, NS_S, 10), {CONTRACT_OP: 7, HEAD_OP: 1, REMAP_OP: 14},
             2 * 14)):
        p = get_preset(name)
        model = build_model(p.model, dtype="bfloat16", device=dev,
                            generator=torch.Generator().manual_seed(0), **p.model_kwargs).eval()
        x = torch.randn(shape, generator=g).to(dev)
        data = export_forward(model, x)
        fn = load_forward(data)
        found = Counter(str(n.target) for n in fn.graph.nodes
                        if str(n.target).startswith("uno_tpu_torch."))
        c0 = _launches()
        with torch.inference_mode():
            got, want_y = fn(x), model(x)
        moved = {k: v - c0[k] for k, v in _launches().items()}
        rel = _rel(got, want_y)
        if (rel > EXPORT_NS_REL or dict(found) != nodes or moved["cmul_fwd"] != 14
                or moved["remap"] != remaps):
            raise AssertionError(f"export {name}: rel-L2 {rel} (bound {EXPORT_NS_REL}), nodes "
                                 f"{dict(found)}, launches {moved}")
        print(f"[export] {name} {p.model} bf16 forward {tuple(shape)}: {len(data) / 1e6:.1f} MB, "
              f"nodes {dict(found)}, served against eager rel-L2 {rel:.3g} (bound "
              f"{EXPORT_NS_REL}); launches of both {moved}")
    return launches


def phase_profile(tmp: str) -> None:
    """``cli train --profile-dir``: one epoch of darcy_s211 on phase_checkpoint's
    generated split; the trace must name the port's kernels."""
    prof = os.path.join(tmp, "prof")
    argv = ["train", "--preset", PRESET, "--data-cache", os.path.join(tmp, "generated.npz"),
            "--ntrain", str(CK_SPLIT[0]), "--nval", str(CK_SPLIT[1]), "--ntest",
            str(CK_SPLIT[2]), "--dtype", "bfloat16", "--device", "cuda", "--epochs", "1",
            "--profile-dir", prof]
    t0 = time.perf_counter()
    _run_cli(argv)
    wall = time.perf_counter() - t0
    files = [os.path.join(prof, f) for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    if len(files) != 1:
        raise AssertionError(f"profile: trace files {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = Counter(e["name"] for e in events if e.get("cat") == "kernel")
    found = {k: sum(n for name, n in kernels.items() if k in name)
             for k in ("contract_kernel", "mlp_head")}
    if not all(found.values()):
        raise AssertionError(f"profile: the trace names no {found}; kernels {list(kernels)[:20]}")
    print(f"[profile] cli train --profile-dir, 1 epoch of {PRESET} uno9 bf16 ({CK_SPLIT[0]} "
          f"samples): {os.path.getsize(files[0]) / 1e6:.1f} MB trace, {sum(kernels.values())} "
          f"kernel events of {len(kernels)} names; the port's kernels {found}; wall {wall:.1f} s")


def phase_custom_ops(tmp: str, dev, predict_ms: list, ns_train_ms: list) -> None:
    """``[predict]`` and ``[ns-train]`` with every eager forward launch routed
    through the kernels' custom ops, then directly again, beside the first
    direct run; and the host time of one call each way at ns2d's deepest
    contraction (enqueue only: 200 calls, one synchronisation after)."""
    direct = (cmul_k._forward, head_k._forward)
    routes = {"direct": direct, "custom op": (cmul_k.contract, head_k.mlp_head_fwd)}
    g = torch.Generator().manual_seed(13)
    b, ci, co, m = NS_CMUL_SHAPES[3]
    x = torch.complex(torch.randn(b, ci, m, generator=g), torch.randn(b, ci, m, generator=g))
    w = torch.complex(torch.randn(ci, co, m, generator=g), torch.randn(ci, co, m, generator=g))
    x, w = x.to(dev), w.to(dev)
    host_us = {}
    for name, (fwd, _) in list(routes.items()) * 2:
        for _ in range(10):
            fwd(x, w)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fwd(x, w)
        host_us.setdefault(name, []).append((time.perf_counter() - t0) / 200 * 1e6)
        torch.cuda.synchronize()
    res = {"direct": [(predict_ms, ns_train_ms)]}
    try:
        for name in ("custom op", "direct"):
            cmul_k._forward, head_k._forward = routes[name]
            p = phase_predict(tmp, f"custom-ops predict, {name}")
            _, t = phase_ns_train(tmp, dev, f"custom-ops ns-train, {name}")
            res[name] = res.get(name, []) + [(p, t)]
    finally:
        cmul_k._forward, head_k._forward = direct
    print(f"[custom-ops] host us per contraction call {b}x{ci}x{co}x{m}, enqueue only: direct "
          f"{[round(v, 2) for v in host_us['direct']]}, through the custom op "
          f"{[round(v, 2) for v in host_us['custom op']]}")
    for i, what in enumerate(("predict ms per batch", "ns-train ms per warm step")):
        parts = [f"{name} run {k + 1} {_spread(runs[i])}" for name in ("direct", "custom op")
                 for k, runs in enumerate(res[name])]
        print(f"[custom-ops] {what}: " + "; ".join(parts))


# The U-NO variants of uno_tpu that the phases above do not run, at their
# published widths: darcy_s85, ns3d_t20/t10/t9 and ns2d_s256 through the CLI;
# uno_p, uno_demo and the uno3d_*_256 family, which have no preset in either
# package, through build_model and the trainers.
S85_PRESET = "darcy_s85"  # uno9, width 32, pad 5, S = 85, batch 16
S85_SPLIT = (48, 16, 64)  # cli train --generate: 3 steps an epoch; 4 test batches to serve
NS3D_SIBLINGS = ("ns3d_t20", "ns3d_t10", "ns3d_t9")  # T_in 10, 10, 6 -> T_f 20, 10, 9
# one `cli generate --task ns` file for the three: 60 trajectories of 30 frames
# half a time unit apart (the fast profile's), read as 32/8 train/val and 20 test
NS3D_MAT_N, NS3D_MAT_FRAMES, NS3D_MAT_SPLIT = 60, 30, (32, 8, 20)
NS3D_SIB_PREDICT = 3 * BATCH  # each sibling's synthetic predict split: 3 batches of 16
S256_PRESET = "ns2d_s256"  # uno_s256, width 32, 256x256, T_in 10 -> T_f 40, batch 4
S256_SPLIT = (8, 4, 16)  # synthetic and learnable: 2 steps an epoch; 4 test batches to serve
S256_CHECK = (1, 2)  # s256-cuda-vs-cpu: 1 sample, a 2-step rollout
UNO_P_KW = dict(in_width=14, width=32, pad=0)  # uno_p's factory: the ns2d task's channels
DEMO_KW = dict(in_width=3, width=32, pad=8)  # uno_demo's factory, on darcy_s211's grid
# the uno3d_*_256 factories and their (T_in, T_f): ns3d_t40/t20/t10/t9's windows
NS3D_256 = {"uno3d_t40_256": (10, 40), "uno3d_t20_256": (10, 20), "uno3d_t10_256": (10, 10),
            "uno3d_t9_256": (6, 9)}
NS3D_256_KW = dict(in_width=6, width=8)  # the factories' pads: 1, 2, 2, 2
NS3D_256_S, NS3D_256_BATCH = 256, 4  # ns2d_s256's batch, the one 256x256 preset
NS3D_256_SPLIT = (8, 4, 4)  # synthetic and learnable: 2 steps an epoch
SERVE_BATCHES = 4  # warm batches a build_model path serves


def _variant_shapes(name: str, batch: int, **kw) -> tuple:
    """(B, Ci, Co, M) of each spectral contraction of a factory's forward, in
    block order (M = 2*m1*m2 in 2-D, 4*m1*m2*m3 in 3-D: the kept corners),
    and its fused head's (B, C, N, H, O) under bf16 with N = 1 for the
    caller to set (None where the model projects through the unfused f32
    Dense pair: 3-D, or the lift concatenated into the head)."""
    spec = MODEL_REGISTRY[name](**kw)
    shapes, chans, cur = [], [], spec.width
    for blk in spec.blocks:
        shapes.append((batch, cur, blk.channels, 2 ** (spec.ndim - 1) * math.prod(blk.modes)))
        cur = blk.channels + (0 if blk.skip is None else
                              spec.width if blk.skip == LIFT else chans[blk.skip])
        chans.append(cur)
    head = (None if spec.ndim == 3 or spec.proj_concat_lift
            else (batch, cur, 1, spec.proj_hidden, spec.out_dim))
    return shapes, head


def _want(nb: int, steps: int, evals: int, head: bool, fwd_step: int = 1, fwd_eval: int = 1,
          bwd_step: int = 1, adam: int = 0, remap: int = 0) -> dict:
    """Launches of ``nb`` contractions a forward over ``steps`` training steps
    (``fwd_step`` forwards, ``bwd_step`` backwards and ``adam`` Adam kernels
    each) and ``evals`` forward-only batches (``fwd_eval`` forwards each),
    the fused head's too where ``head``, ``remap`` remaps a forward and a
    backward."""
    f, b, h = fwd_step * steps + fwd_eval * evals, bwd_step * steps, int(head)
    return {"cmul_fwd": nb * f, "cmul_bwd_x": nb * b, "cmul_bwd_w": nb * b,
            "mlp_head_fwd": h * f, "mlp_head_bwd": h * b, "adam_step": adam * steps,
            "remap": remap * (f + b)}


def _rollout_counts(t_f: int) -> dict:
    """A rollout of ``t_f`` steps: every step's forward runs twice in a
    training step (the checkpoint's recompute) and its backward once."""
    return dict(fwd_step=2 * t_f, fwd_eval=t_f, bwd_step=t_f)


def _smooth_fields(rng, n: int, s: int, t: int) -> np.ndarray:
    """(n, s, s, t) f32 fields of unit scale: white noise kept to the
    wavenumbers below 5, like a vorticity field's large scales."""
    z = np.fft.rfft2(rng.standard_normal((n, t, s, s)), axes=(2, 3))
    k = np.fft.fftfreq(s, 1.0 / s)
    z[..., (np.abs(k)[:, None] > 4) | (np.arange(s // 2 + 1)[None, :] > 4)] = 0
    f = np.fft.irfft2(z, s=(s, s), axes=(2, 3))
    return (f / f.std()).transpose(0, 2, 3, 1).astype(np.float32)


def _learnable_ns(rng, n: int, s: int, t_in: int, t_f: int) -> tuple:
    """(inputs, targets) that a model can learn in a few steps: smooth input
    windows, and targets that are the window's last frame decaying by 0.9 a
    step."""
    a = _smooth_fields(rng, n, s, t_in)
    return a, a[..., -1:] * (0.9 ** np.arange(1, t_f + 1, dtype=np.float32))


def _splits(a, u, split) -> tuple:
    """The six split arrays of (a, u) cut as (ntrain, nval, ntest)."""
    i1, i2 = split[0], split[0] + split[1]
    return a[:i1], u[:i1], a[i1:i2], u[i1:i2], a[i2:], u[i2:]


def _train_run(dev, run) -> tuple:
    """``run()`` (a ``cli train`` or a trainer, returning its records) with
    the counts set to 0 just before and the contraction shapes recorded:
    (records, launches, shapes, peak device GB, wall s)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_launches()
    t0 = time.perf_counter()
    with _record_shapes() as shapes:
        records = run()
    torch.cuda.synchronize()
    return (records, _launches(), dict(shapes), torch.cuda.max_memory_allocated(dev) / 1e9,
            time.perf_counter() - t0)


def _trainer(model, trainer, data, cfg, **kw):
    """A ``run`` for ``_train_run``: the trainer's records."""
    def run():
        rec = _Records()
        trainer(model, *data, cfg, logger=rec, **kw)
        return rec.records
    return run


def _check_train(tag: str, what: str, run: tuple, shapes: list, head: bool, batch: int,
                 nval: int, ntest: int, adam: int, t_f: int = None, remap: int = 0) -> list:
    """A training run of ``_train_run``: EPOCHS epochs, every logged rel-L2
    finite, the train loss falling, each kernel's launches from the steps and
    evaluation batches (``adam`` Adam kernels a step; ``t_f``: a rollout), the
    contraction shapes at the
    full batch those of ``shapes``; prints it and returns the warm ms per
    step."""
    records, launches, got_shapes, peak_gb, wall = run
    key = "train_rel_l2" if "train_rel_l2" in records[0] else "train_step_rel_l2"
    epochs = [r for r in records if key in r]
    validated = [r for r in epochs if key.replace("train", "val") in r]
    losses = [v for r in records for k, v in r.items() if k.endswith("rel_l2")]
    if (len(epochs) != EPOCHS or not any(k.startswith("test_") for k in records[-1])
            or not np.isfinite(losses).all()):
        raise AssertionError(f"[{tag}]: {len(epochs)} epochs, records {records}")
    if not epochs[-1][key] < epochs[0][key]:
        raise AssertionError(f"[{tag}]: loss did not fall: {[r[key] for r in epochs]}")
    steps = epochs[-1]["step"]
    evals = len(validated) * -(-nval // batch) + -(-ntest // batch)  # forward-only batches
    want = _want(len(shapes), steps, evals, head, adam=adam, remap=remap,
                 **(_rollout_counts(t_f) if t_f else {}))
    want_shapes = {(use, *sh) for sh in shapes for use in ("cmul_fwd", "cmul_bwd_x",
                                                            "cmul_bwd_w")}
    full = {k for k in got_shapes if k[1] == batch}
    if launches != want or full != want_shapes:
        raise AssertionError(f"[{tag}] launches {launches}, expected {want} ({steps} steps, "
                             f"{evals} eval batches); contraction shapes {sorted(full)}, "
                             f"expected {sorted(want_shapes)}")
    warm = [ms for r in epochs[1:] for ms in r["step_ms"]]
    print(f"[{tag}] {what}: {steps} steps in {EPOCHS} epochs, {key} "
          f"{[round(r[key], 5) for r in epochs]}, validated epochs "
          f"{[r['epoch'] for r in validated]}, test "
          f"{ {k: round(v, 5) for k, v in records[-1].items() if k.startswith('test_')} }; "
          f"launches {launches}; contraction shapes at batch {batch} as the kernels were timed")
    print(f"[{tag}] step_ms warm {_spread(warm)} (epochs 2-{EPOCHS}: "
          f"{[round(v, 3) for v in warm]}), first step {epochs[0]['step_ms'][0]:.1f}; peak "
          f"device memory {peak_gb:.3f} GB; wall {wall:.1f} s")
    return warm


def _cli_predict(tag: str, argv: list, out: str, pred_shape: tuple, nb: int, head: bool,
                 per_batch: int = 1, remap: int = 0) -> list:
    """``cli predict`` once to warm up and once measured, the counts set to 0
    between: the output, the launches (``per_batch`` forwards a batch), the
    ms per batch host to host."""
    warm = _run_cli(argv)[-1]
    _zero_launches()
    report = _run_cli(argv)[-1]
    launches = _launches()
    ms = report["batch_ms"]
    pred = np.load(out)["pred"]
    want = _want(nb, 0, len(ms), head, fwd_eval=per_batch, remap=remap)
    if (pred.shape != pred_shape or not np.isfinite(pred).all() or launches != want
            or report["spectral"] != "fft" or report["dtype"] != "bfloat16"):
        raise AssertionError(f"[{tag}]: pred {pred.shape} (expected {pred_shape}), finite "
                             f"{np.isfinite(pred).all()}, launches {launches} (expected {want}), "
                             f"{report}")
    print(f"[{tag}] {report['predict']} {report['model']} bf16 b{report['batch_size']}: "
          f"{len(ms)} warm batches host to host, ms per batch {_spread(ms)} "
          f"({[round(v, 3) for v in ms]}; first run {[round(v, 3) for v in warm['batch_ms']]}); "
          f"launches {launches}")
    return ms


def _serve(tag: str, what: str, dev, fwd, xs: np.ndarray, batch: int, out_shape: tuple,
           nb: int, head: bool, per_batch: int = 1, remap: int = 0) -> list:
    """The serving forward under ``inference_mode``: one batch to warm up,
    then ``len(xs) // batch`` batches host to host, the counts set to 0
    between; checks each output and the launches."""
    n = len(xs) // batch
    with torch.inference_mode():
        fwd(torch.from_numpy(xs[:batch]).to(dev)).cpu()
        _zero_launches()
        ms, finite = [], True
        for i in range(n):
            t0 = time.perf_counter()
            y = fwd(torch.from_numpy(xs[i * batch : (i + 1) * batch]).to(dev)).cpu()
            ms.append((time.perf_counter() - t0) * 1e3)
            finite &= bool(torch.isfinite(y).all()) and tuple(y.shape) == (batch, *out_shape)
    launches, want = _launches(), _want(nb, 0, n, head, fwd_eval=per_batch, remap=remap)
    if not finite or launches != want:
        raise AssertionError(f"[{tag}]: outputs finite and {(batch, *out_shape)}: {finite}; "
                             f"launches {launches}, expected {want}")
    print(f"[{tag}] {what}: {n} warm batches of {batch} host to host, ms per batch "
          f"{_spread(ms)} ({[round(v, 3) for v in ms]}); launches {launches}")
    return ms


def _card_vs_cpu(tag: str, dev, name: str, kw: dict, x, y, fwd, loss, head: bool,
                 t_f: int = None) -> None:
    """``name`` with the same weights on the card and the CPU, f32 and bf16:
    the forward alone (``fwd(model, x)`` under ``inference_mode``), then the
    loss ``loss(model, x, y)`` and every gradient, within E2E_REL and
    GRAD_REL; the card's launches (``t_f``: a rollout)."""
    spec = MODEL_REGISTRY[name](**kw)
    nb, reps = len(spec.blocks), t_f or 1
    what = f"{name} width {spec.width} {x.shape[1]}x{x.shape[2]} b{x.shape[0]}" + (
        f" T_f={t_f}" if t_f else f" T_in={x.shape[3]} -> T_f={y.shape[3]}" if spec.ndim == 3
        else "")
    for dtype in ("float32", "bfloat16"):
        cpu = build_model(name, dtype=dtype, generator=torch.Generator().manual_seed(0), **kw)
        gpu = build_model(name, dtype=dtype, device=dev, **kw)
        gpu.load_state_dict(cpu.state_dict())
        res = []
        for model, d in ((cpu, "cpu"), (gpu, dev)):
            c0, r0 = _launches(), sum(spectral.REMAPS.values())
            with torch.inference_mode():
                out = fwd(model, x.to(d))
            value = loss(model, x.to(d), y.to(d))
            value.backward()
            res.append((out, value.detach(), torch.cat([
                torch.view_as_real(p.grad).flatten() if p.is_complex() else p.grad.flatten()
                for p in model.parameters()])))
            if d == "cpu":  # the card launches a kernel for each remap the CPU ran
                cpu_remaps = sum(spectral.REMAPS.values()) - r0
        moved = {k: v - c0[k] for k, v in _launches().items()}
        want = dict(_want(nb, 1, 1, head and dtype == "bfloat16", fwd_step=2 * reps if t_f else 1,
                          fwd_eval=reps, bwd_step=reps), remap=cpu_remaps)
        ro, rl, rg = (_rel(g, w) for g, w in zip(res[1], res[0]))
        if not (torch.isfinite(res[1][0]).all() and torch.isfinite(res[1][2]).all()
                and ro <= E2E_REL[dtype] and max(rl, rg) <= GRAD_REL[dtype] and moved == want):
            raise AssertionError(f"[{tag}] {dtype}: output rel-L2 {ro} (bound {E2E_REL[dtype]}), "
                                 f"loss rel {rl}, grads rel-L2 {rg} (bound {GRAD_REL[dtype]}), "
                                 f"card launches {moved}, expected {want}")
        print(f"[{tag}] {what} {dtype}: output rel-L2 {ro:.3g} (bound {E2E_REL[dtype]}), loss "
              f"rel {rl:.3g}, all gradients rel-L2 {rg:.3g} (bound {GRAD_REL[dtype]}); card "
              f"launches {moved}")
        del cpu, gpu, res


def _darcy_loss(model, x, y):
    return relative_lp_loss(model(x).reshape(y.shape), y)


def _forecast_fns(t_f: int) -> tuple:
    """(fwd, loss) of a 3-D model for ``_card_vs_cpu``."""
    return (lambda m, x: forecast(m, x, t_f),
            lambda m, x, y: relative_lp_loss(forecast(m, x, t_f), y))


def _rollout_fns(t_f: int) -> tuple:
    """(fwd, loss) of a rollout of ``t_f`` steps for ``_card_vs_cpu``: the
    forward alone is the trajectory fed zero targets, as ``cli predict``."""
    def fwd(m, x):
        return make_rollout(m, t_f)(x, torch.zeros(x.shape[:3] + (t_f,), device=x.device))[1]
    return fwd, lambda m, x, y: make_rollout(m, t_f)(x, y)[0]


def _pair(rng, shape_x, shape_y) -> tuple:
    return (torch.from_numpy(rng.standard_normal(shape_x).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(shape_y).astype(np.float32)))


def phase_s85(tmp: str, dev) -> dict:
    """darcy_s85: ``cli train --generate`` (the generator at s = 85), then
    ``cli predict`` of the same split's 64 test samples; returns the train
    run's launches."""
    data = os.path.join(tmp, "darcy_s85.npz")
    ntrain, nval, ntest = S85_SPLIT
    split = ["--preset", S85_PRESET, "--data-cache", data, "--ntrain", str(ntrain), "--nval",
             str(nval), "--ntest", str(ntest), "--dtype", "bfloat16", "--device", "cuda"]
    shapes, head = _variant_shapes("uno9", BATCH, **get_preset(S85_PRESET).model_kwargs)
    run = _train_run(dev, lambda: _run_cli(["train", *split, "--generate",
                                            "--epochs", str(EPOCHS)]))
    kw = get_preset(S85_PRESET).model_kwargs
    _check_train("s85-train", f"{S85_PRESET} uno9 bf16 b{BATCH}, generated {sum(S85_SPLIT)} "
                 f"samples at 85x85", run, shapes, True, BATCH, nval, ntest,
                 _adam_per_step("uno9", **kw),
                 remap=_remaps("uno9", "bfloat16", (85, 85, 1), **kw))
    out = os.path.join(tmp, "s85_preds.npz")
    _cli_predict("s85-predict", ["predict", *split, "--init-seed", "0", "--split", "test",
                                 "--out", out], out, (ntest, 85, 85), len(shapes), True,
                 remap=_remaps("uno9", "bfloat16", (85, 85, 1), **kw))
    return run[1]


def phase_ns3d_siblings(tmp: str, dev) -> dict:
    """ns3d_t20, t10 and t9: one ``cli generate --task ns`` file of 30-frame
    trajectories for the three, ``cli train --data`` of it for each, and
    ``cli predict`` of a synthetic split of 3 batches of 16; returns each
    preset's train launches."""
    mat = os.path.join(tmp, "ns3d_siblings.mat")
    _run_cli(["generate", "--task", "ns", "--out", mat, "--n", str(NS3D_MAT_N), "--size",
              str(NS_S), "--T", str(NS3D_MAT_FRAMES * 0.5), "--delta-t", "1e-3",
              "--record-steps", str(NS3D_MAT_FRAMES), "--device", "cuda"])
    ntrain, nval, ntest = NS3D_MAT_SPLIT
    out = {}
    for name in NS3D_SIBLINGS:
        preset = get_preset(name)
        tag = name.replace("_", "-")
        shapes, _ = _variant_shapes(preset.model, BATCH, **preset.model_kwargs)
        run = _train_run(dev, lambda: _run_cli([
            "train", "--preset", name, "--data", mat, "--ntrain", str(ntrain), "--nval",
            str(nval), "--ntest", str(ntest), "--epochs", str(EPOCHS), "--dtype", "bfloat16",
            "--device", "cuda"]))
        _check_train(f"{tag}-train", f"{name} {preset.model} bf16 b{BATCH} T_in={preset.t_in} "
                     f"-> T_f={preset.t_f}, --data of {NS3D_MAT_N} generated trajectories",
                     run, shapes, False, BATCH, nval, ntest,
                     _adam_per_step(preset.model, **preset.model_kwargs), remap=3 * len(shapes))
        data, pred = os.path.join(tmp, f"{name}.npz"), os.path.join(tmp, f"{name}_preds.npz")
        _write_ns3d_split(data, np.random.default_rng(14), NS3D_SIB_PREDICT, name)
        _cli_predict(f"{tag}-predict", [
            "predict", "--preset", name, "--dtype", "bfloat16", "--init-seed", "0",
            "--data-cache", data, "--ntrain", "0", "--nval", "0", "--ntest",
            str(NS3D_SIB_PREDICT), "--split", "test", "--out", pred, "--device", "cuda"],
            pred, (NS3D_SIB_PREDICT, NS_S, NS_S, preset.t_f), len(shapes), False,
            remap=3 * len(shapes))
        out[name] = run[1]
    return out


def phase_s256(tmp: str, dev) -> dict:
    """ns2d_s256: ``cli train`` (the 40-step rollout, full BPTT, each step
    rematerialised) and ``cli predict`` of one synthetic learnable split at
    256x256 (the NS generator is not run at 256x256 here); returns the train
    run's launches."""
    preset = get_preset(S256_PRESET)
    ntrain, nval, ntest = S256_SPLIT
    a, u = _learnable_ns(np.random.default_rng(15), sum(S256_SPLIT), preset.size,
                         preset.t_in, preset.t_f)
    sized = get_preset(S256_PRESET, ntrain=ntrain, nval=nval, ntest=ntest)
    data = os.path.join(tmp, "ns2d_s256.npz")
    np.savez(data, **dict(zip(cli._SPLIT_KEYS, _splits(a, u, S256_SPLIT))),
             config_sig=np.asarray(cli._gen_sig(sized)))
    split = ["--preset", S256_PRESET, "--data-cache", data, "--ntrain", str(ntrain), "--nval",
             str(nval), "--ntest", str(ntest), "--dtype", "bfloat16", "--device", "cuda"]
    bs = preset.train.batch_size
    shapes, _ = _variant_shapes(preset.model, bs, **preset.model_kwargs)
    run = _train_run(dev, lambda: _run_cli(["train", *split, "--epochs", str(EPOCHS)]))
    remaps = _remaps(preset.model, "bfloat16", (preset.size, preset.size, preset.t_in),
                     **preset.model_kwargs)
    _check_train("s256-train", f"{S256_PRESET} uno_s256 bf16 b{bs} T_f={preset.t_f} BPTT, a "
                 f"synthetic {preset.size}x{preset.size} split", run, shapes, False, bs, nval,
                 ntest, _adam_per_step(preset.model, **preset.model_kwargs), t_f=preset.t_f,
                 remap=remaps)
    out = os.path.join(tmp, "s256_preds.npz")
    _cli_predict("s256-predict", ["predict", *split, "--init-seed", "0", "--split", "test",
                                  "--out", out],
                 out, (ntest, preset.size, preset.size, preset.t_f), len(shapes), False,
                 per_batch=preset.t_f, remap=remaps)
    return run[1]


def phase_uno_p(tmp: str, dev) -> dict:
    """uno_p on the ns2d task through ``build_model``: ``train_ns2d`` on
    phase_ns_train's generated split, and the serving rollout over
    phase_ns_predict's test split; returns the train run's launches."""
    preset = get_preset(NS_PRESET)
    shapes, _ = _variant_shapes("uno_p", BATCH, **UNO_P_KW)
    model = build_model("uno_p", dtype="bfloat16", device=dev,
                        generator=torch.Generator().manual_seed(0), **UNO_P_KW)
    split = _load_split(os.path.join(tmp, "ns2d_train.npz"))
    cfg = dataclasses.replace(preset.train, epochs=EPOCHS)
    run = _train_run(dev, _trainer(model, train_ns2d, split, cfg, t_f=preset.t_f))
    _check_train("uno-p-train", f"uno_p width {UNO_P_KW['width']} bf16 b{BATCH} "
                 f"T_f={preset.t_f} BPTT, train_ns2d on the generated ns2d split", run, shapes,
                 False, BATCH, len(split[2]), len(split[4]), _adam_per_step("uno_p", **UNO_P_KW),
                 t_f=preset.t_f, remap=_remaps("uno_p", "bfloat16", (NS_S, NS_S, preset.t_in),
                                               **UNO_P_KW))
    xs = _load_split(os.path.join(tmp, "ns2d.npz"))[4][: SERVE_BATCHES * BATCH]
    rollout = _rollout_fns(preset.t_f)[0]
    model.eval()
    _serve("uno-p-predict", f"uno_p bf16 rollout T_f={preset.t_f}", dev,
           lambda x: rollout(model, x), xs, BATCH, (NS_S, NS_S, preset.t_f),
           len(shapes), False, per_batch=preset.t_f,
           remap=_remaps("uno_p", "bfloat16", (NS_S, NS_S, preset.t_in), **UNO_P_KW))
    return run[1]


def phase_uno_demo(tmp: str, dev) -> dict:
    """uno_demo (13 blocks) on darcy_s211's grid through ``build_model``:
    ``train_darcy`` on phase_train's split, and the serving forward over
    phase_predict's test split; returns the train run's launches."""
    shapes, _ = _variant_shapes("uno_demo", BATCH, **DEMO_KW)
    model = build_model("uno_demo", dtype="bfloat16", device=dev,
                        generator=torch.Generator().manual_seed(0), **DEMO_KW)
    split = _load_split(os.path.join(tmp, "darcy_s211_train.npz"))
    cfg = dataclasses.replace(get_preset(PRESET).train, epochs=EPOCHS)
    run = _train_run(dev, _trainer(model, train_darcy, split, cfg))
    _check_train("uno-demo-train", f"uno_demo width {DEMO_KW['width']} pad 8 bf16 b{BATCH} at "
                 f"{S}x{S}, train_darcy", run, shapes, True, BATCH, len(split[2]), len(split[4]),
                 _adam_per_step("uno_demo", **DEMO_KW),
                 remap=_remaps("uno_demo", "bfloat16", (S, S, 1), **DEMO_KW))
    xs = _load_split(os.path.join(tmp, "darcy_s211.npz"))[4][: SERVE_BATCHES * BATCH]
    model.eval()
    _serve("uno-demo-predict", "uno_demo bf16 forward", dev, model, xs, BATCH,
           (S, S, 1), len(shapes), True, remap=_remaps("uno_demo", "bfloat16", (S, S, 1),
                                                       **DEMO_KW))
    return run[1]


def phase_ns3d_256(dev) -> dict:
    """The four uno3d_*_256 factories at 256x256, batch 4, through
    ``build_model``: ``train_ns3d`` on a synthetic learnable split, then the
    serving ``forecast``; returns each one's train launches."""
    cfg = dataclasses.replace(get_preset(NS3D_PRESET).train, epochs=EPOCHS,
                              batch_size=NS3D_256_BATCH)
    s, bs = NS3D_256_S, NS3D_256_BATCH
    out = {}
    for name, (t_in, t_f) in NS3D_256.items():
        tag = name.replace("uno3d_", "ns3d-").replace("_", "-")
        shapes, _ = _variant_shapes(name, bs, **NS3D_256_KW)
        n = sum(NS3D_256_SPLIT)
        a, u = _learnable_ns(np.random.default_rng(16), n + SERVE_BATCHES * bs, s, t_in, t_f)
        model = build_model(name, dtype="bfloat16", device=dev,
                            generator=torch.Generator().manual_seed(0), **NS3D_256_KW)
        split = _splits(a[:n], u[:n], NS3D_256_SPLIT)
        run = _train_run(dev, _trainer(model, train_ns3d, split, cfg, t_f=t_f))
        _check_train(f"{tag}-train", f"{name} width {NS3D_256_KW['width']} bf16 b{bs} {s}x{s} "
                     f"T_in={t_in} -> T_f={t_f}, train_ns3d on a synthetic split", run, shapes,
                     False, bs, NS3D_256_SPLIT[1], NS3D_256_SPLIT[2],
                     _adam_per_step(name, **NS3D_256_KW), remap=3 * len(shapes))
        model.eval()
        _serve(f"{tag}-predict", f"{name} bf16 forecast", dev,
               lambda x: forecast(model, x, t_f), a[n:], bs, (s, s, t_f),
               len(shapes), False, remap=3 * len(shapes))
        out[name] = run[1]
        del model, run, split, a, u
    return out


def phase_variants_cuda_vs_cpu(dev) -> None:
    """Each new path's model at full width on 1-2 samples, card against CPU
    with the same weights: the forward alone, the loss and every gradient,
    f32 and bf16 (rollouts at T_f = 2)."""
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.standard_normal((2, 85, 85, 1)).astype(np.float32))
    _card_vs_cpu("s85-cuda-vs-cpu", dev, "uno9", get_preset(S85_PRESET).model_kwargs, x,
                 (x[..., 0] + x[..., 0].roll(1, 1)) / 2, lambda m, x_: m(x_), _darcy_loss, True)
    for name in NS3D_SIBLINGS:
        p = get_preset(name)
        x, y = _pair(rng, (2, NS_S, NS_S, p.t_in), (2, NS_S, NS_S, p.t_f))
        _card_vs_cpu(f"{name.replace('_', '-')}-cuda-vs-cpu", dev, p.model, p.model_kwargs, x, y,
                     *_forecast_fns(p.t_f), False)
    p = get_preset(S256_PRESET)
    b, t_f = S256_CHECK
    x, y = _pair(rng, (b, p.size, p.size, p.t_in), (b, p.size, p.size, t_f))
    _card_vs_cpu("s256-cuda-vs-cpu", dev, p.model, p.model_kwargs, x, y, *_rollout_fns(t_f),
                 False, t_f=t_f)
    x, y = _pair(rng, (2, NS_S, NS_S, 10), (2, NS_S, NS_S, 2))
    _card_vs_cpu("uno-p-cuda-vs-cpu", dev, "uno_p", UNO_P_KW, x, y, *_rollout_fns(2), False,
                 t_f=2)
    x = torch.from_numpy(rng.standard_normal((2, S, S, 1)).astype(np.float32))
    _card_vs_cpu("uno-demo-cuda-vs-cpu", dev, "uno_demo", DEMO_KW, x,
                 (x[..., 0] + x[..., 0].roll(1, 1)) / 2, lambda m, x_: m(x_), _darcy_loss, True)
    for name, (t_in, t_f) in NS3D_256.items():
        x, y = _pair(rng, (1, NS3D_256_S, NS3D_256_S, t_in), (1, NS3D_256_S, NS3D_256_S, t_f))
        _card_vs_cpu(f"{name.replace('uno3d_', 'ns3d-').replace('_', '-')}-cuda-vs-cpu", dev,
                     name, NS3D_256_KW, x, y, *_forecast_fns(t_f), False)


# (key of the kernels line, tag, factory, factory kwargs, batch, head's N or None)
VARIANT_KERNELS = (
    ("s85", "kernels s85", "uno9", get_preset(S85_PRESET).model_kwargs, BATCH, 85 * 85),
    *((n, f"kernels {n.replace('_', '-')}", get_preset(n).model, get_preset(n).model_kwargs,
       BATCH, None) for n in NS3D_SIBLINGS),
    ("s256", "kernels s256", "uno_s256", get_preset(S256_PRESET).model_kwargs,
     get_preset(S256_PRESET).train.batch_size, None),
    ("uno_p", "kernels uno-p", "uno_p", UNO_P_KW, BATCH, None),
    ("uno_demo", "kernels uno-demo", "uno_demo", DEMO_KW, BATCH, S * S),
    *((n.replace("uno3d", "ns3d"), f"kernels {n.replace('uno3d_', 'ns3d-').replace('_', '-')}",
       n, NS3D_256_KW, NS3D_256_BATCH, None) for n in NS3D_256),
)


def phase_variant_kernels(dev) -> dict:
    """The five kernels at each new path's shapes (``phase_kernels``)."""
    out = {}
    for key, tag, name, kw, batch, n in VARIANT_KERNELS:
        shapes, head = _variant_shapes(name, batch, **kw)
        out[key] = phase_kernels(dev, shapes, None if n is None else (*head[:2], n, *head[3:]),
                                 tag)
    return out


FUSED_REL, FUSED_BF16_REL = 1e-5, 2e-2  # [fused-skips]: fused against materialized
FUSED_CPU_REL = 1e-4  # [fused-skips]: the fused form on the card against the CPU
FUSED_STEPS, FUSED_SERVES = 12, 8  # [fused-skips] darcy_s211: timed steps, served batches a form
ADAM_STEPS, ADAM_REPS = 20, 50  # [adam]: steps held against plain; optimizer steps timed
ADAM_KERNEL_REPS, ADAM_ULPS = 40, 2  # [adam]: kernel launches timed; ulps from plain
ADAM_COUNTED = 10  # [adam]: steps whose launches are counted
KERNEL_COUNT_PAD = 0.05  # s of idle on each side of a profiler-counted call
NO_FUSED = "UNO_TPU_TORCH_NO_FUSED_SKIPS"
FORMS = {"fused": {}, "materialized": {NO_FUSED: 1}}  # the skip forms: their environment


def _kernel_count(fn) -> int:
    """The CUDA kernels that one call of ``fn`` launches, counted in a
    ``torch.profiler`` trace of its second call: the profiler's warm-up
    step takes the first (a trace of a first step can miss its first
    kernels).  The profiler puts the card's activities on the host's clock
    with an offset that changes from window to window (up to 4.8 ms on the
    H100) and drops those it puts outside the window, so the call
    sits between KERNEL_COUNT_PAD seconds of idle on each side."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=acts, schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
                on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            for _ in range(2):
                time.sleep(KERNEL_COUNT_PAD)
                fn()
                torch.cuda.synchronize()
                time.sleep(KERNEL_COUNT_PAD)
                prof.step()
        with open(path) as f:
            n = sum(1 for e in json.load(f)["traceEvents"]
                    if e.get("ph") == "X" and e.get("cat") == "kernel")
    if not n:
        raise AssertionError("the profiler saw no kernel on the card")
    return n


def _host_ms(fn) -> float:
    """One call of ``fn`` to its end on the card, on the host's clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _skip_case(dev, preset_name: str, batch: int, seed: int) -> dict:
    """One preset's model in f32 with its own optimizer and a random batch:
    the serving call and the training step (the loss the trainer takes, a
    backward, ``ComplexAdam``) as functions of the form's model."""
    preset = get_preset(preset_name)
    rng = np.random.default_rng(seed)
    s = preset.size if preset.task == "ns2d" else S421 if preset_name == S421_PRESET else S
    if preset.task == "ns2d":
        x, y = _pair(rng, (batch, s, s, preset.t_in), (batch, s, s, preset.t_f))
    else:
        x, y = _pair(rng, (batch, s, s, 1), (batch, s, s))
    x, y = x.to(dev), y.to(dev)
    model = build_model(preset.model, device=dev, generator=torch.Generator().manual_seed(0),
                        **preset.model_kwargs)
    opt = make_optimizer(preset.train, 4, model.parameters())

    def loss():
        if preset.task == "ns2d":
            return make_rollout(model, preset.t_f)(x, y)[0]
        return relative_lp_loss(model(x).reshape(y.shape), y, reduction="sum")

    def serve():
        with torch.inference_mode():
            if preset.task == "ns2d":
                make_rollout(model, preset.t_f)(x, torch.zeros_like(y))
            else:
                model(x)

    def step():
        opt.zero_grad(set_to_none=True)
        loss().backward()
        opt.step()

    what = f"{preset_name} {preset.model} f32 b{batch} {s}x{s}" + (
        f" T_f={preset.t_f} rollout" if preset.task == "ns2d" else "")
    return dict(model=model, serve=serve, step=step, what=what, x=x, y=y,
                nb=len(model.spec.blocks), rollout=preset.t_f if preset.task == "ns2d" else 1,
                name=preset.model, kw=preset.model_kwargs,
                adam=_adam_per_step(preset.model, **preset.model_kwargs))


def _time_forms(dev, case: dict, steps: int, serves: int) -> dict:
    """Each skip form of ``case``'s model: its warm serving and step times
    (in turns fused, materialized, materialized, fused, half of them a
    turn), peak device memory in training, the profiler's kernels a step
    and a served batch, and the port's kernels a step."""
    res = {f: dict(serve_ms=[], step_ms=[]) for f in FORMS}
    for form, env in FORMS.items():
        with _env(**env):
            case["serve"]()
            case["step"]()  # warm: cuFFT plans, cuBLAS handles, the allocator
            torch.cuda.reset_peak_memory_stats(dev)
            _zero_launches()
            res[form]["step_ms"].append(_host_ms(case["step"]))
            res[form]["launches"] = _launches()
            res[form]["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
            res[form]["kernels_step"] = _kernel_count(case["step"])
            res[form]["kernels_serve"] = _kernel_count(case["serve"])
    for form in ("fused", "materialized", "materialized", "fused"):
        with _env(**FORMS[form]):
            res[form]["step_ms"] += [_host_ms(case["step"]) for _ in range(steps // 2)]
            res[form]["serve_ms"] += [_host_ms(case["serve"]) for _ in range(max(serves // 2, 1))]
    nb, reps = case["nb"], case["rollout"]
    fwd = reps * (2 if reps > 1 else 1)
    for form, r in res.items():
        with _env(**FORMS[form]):
            remaps = _remaps(case["name"], "float32", tuple(case["x"].shape[1:]), **case["kw"])
        want = {"cmul_fwd": nb * fwd, "cmul_bwd_x": nb * reps, "cmul_bwd_w": nb * reps,
                "mlp_head_fwd": 0, "mlp_head_bwd": 0, "adam_step": case["adam"],
                "remap": remaps * (fwd + reps)}
        if r["launches"] != want:
            raise AssertionError(f"[fused-skips] {case['what']} {form}: kernel launches a step "
                                 f"{r['launches']}, expected {want}")
        print(f"[fused-skips] {case['what']} {form}: serve ms a batch {_spread(r['serve_ms'])}; "
              f"step ms {_spread(r['step_ms'])} over {len(r['step_ms'])} steps (the first, "
              f"after one warm step, {r['step_ms'][0]:.3f}); peak device memory in training "
              f"{r['peak_gb']:.4f} GB; kernels a step {r['kernels_step']}, a served batch "
              f"{r['kernels_serve']} (profiler); port kernels a step {r['launches']}")
    return res


def _grads_of(model, x, y) -> tuple:
    """The forward's output and all the parameters' gradients of the Darcy
    loss as one vector (complex ones as their (re, im) pairs): the gradients
    of a bias that an instance norm follows are rounding noise about 0,
    which no relative bound of its own can hold."""
    model.zero_grad(set_to_none=True)
    out = model(x)
    relative_lp_loss(out.reshape(y.shape), y, reduction="sum").backward()
    return out.detach(), torch.cat([
        torch.view_as_real(p.grad).flatten() if p.is_complex() else p.grad.flatten()
        for p in model.parameters()])


def phase_fused_skips(dev) -> dict:
    """The skip concats carried as channel pieces (the f32 default of a 2-D
    model) against the materialized form (``UNO_TPU_TORCH_NO_FUSED_SKIPS=1``):
    darcy_s211 uno9 f32 batch 16 (serving, steps, memory, launches; output
    and every gradient of the two forms on the card, and the fused form on
    the card against the CPU on 2 samples); darcy_s421 uno11 f32 batch 4
    and ns2d uno f32 batch 16 (a few steps and served rollouts each way);
    uno9 under bf16, the default (materialized) against
    ``UNO_TPU_TORCH_FUSED_SKIPS=1``.  Returns the fused darcy_s211 steps'
    port kernel launches (one step)."""
    case = _skip_case(dev, PRESET, BATCH, 31)
    res = _time_forms(dev, case, FUSED_STEPS, FUSED_SERVES)
    model, x, y = case["model"], case["x"], case["y"]
    grads = {}
    for form, env in FORMS.items():
        with _env(**env):
            grads[form] = _grads_of(model, x, y)
    card_rel = max(_rel(a, b) for a, b in zip(grads["fused"], grads["materialized"]))
    cpu = build_model("uno9", generator=torch.Generator().manual_seed(0),
                      **get_preset(PRESET).model_kwargs)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    on_card = _grads_of(model, x[:2], y[:2])
    on_cpu = _grads_of(cpu, x[:2].cpu(), y[:2].cpu())
    cpu_out, cpu_grads = (_rel(a, b) for a, b in zip(on_card, on_cpu))
    if card_rel > FUSED_REL or cpu_out > FUSED_CPU_REL or cpu_grads > FUSED_CPU_REL:
        raise AssertionError(f"[fused-skips] {case['what']}: fused against materialized on the "
                             f"card {card_rel} (bound {FUSED_REL}); fused on the card against "
                             f"the CPU: output {cpu_out}, gradients {cpu_grads} (bound "
                             f"{FUSED_CPU_REL})")
    print(f"[fused-skips] {case['what']}: fused against materialized on the card, output and "
          f"all the gradients, the worse rel-L2 {card_rel:.3g} (bound {FUSED_REL}); fused on the "
          f"card against the CPU, 2 samples: output rel-L2 {cpu_out:.3g}, all the gradients "
          f"rel-L2 {cpu_grads:.3g} (bound {FUSED_CPU_REL})")
    del case, model, cpu, grads
    for name, batch, steps, serves in ((S421_PRESET, S421_BATCH, 4, 4),
                                       (NS_PRESET, BATCH, 2, 2)):
        _time_forms(dev, _skip_case(dev, name, batch, 32), steps, serves)
    bf16 = build_model("uno9", dtype="bfloat16", device=dev,
                       generator=torch.Generator().manual_seed(0),
                       **get_preset(PRESET).model_kwargs)
    xb = x.clone()
    outs, ms = {}, {}
    for form, env in (("default (materialized)", {}),
                      ("UNO_TPU_TORCH_FUSED_SKIPS=1", {"UNO_TPU_TORCH_FUSED_SKIPS": 1})):
        with _env(**env), torch.inference_mode():
            bf16(xb)
            ms[form] = [_host_ms(lambda: bf16(xb)) for _ in range(FUSED_SERVES)]
            outs[form] = bf16(xb).float()
    rel = _rel(*outs.values())
    if not rel <= FUSED_BF16_REL:
        raise AssertionError(f"[fused-skips] uno9 bf16: forced fused against the default, "
                             f"rel-L2 {rel} (bound {FUSED_BF16_REL})")
    print(f"[fused-skips] {PRESET} uno9 bf16 b{BATCH}: "
          + "; ".join(f"{f} serve ms a batch {_spread(v)}" for f, v in ms.items())
          + f"; forced fused against the default, output rel-L2 {rel:.3g} (bound "
          f"{FUSED_BF16_REL})")
    return res["fused"]["launches"]


def phase_adam(dev) -> dict:
    """``ComplexAdam`` on uno9's darcy_s211 parameters on the card, f32,
    through the Adam kernel: ADAM_STEPS steps, against the plain sequence of
    torch ops on the card given the same gradients, within ADAM_ULPS; then
    the kernel's ms a step (median of ADAM_KERNEL_REPS launches, L2
    flushed) against its bound, the optimizer's ms per step (CUDA events,
    median of ADAM_REPS), host to host ms, and kernels per step by the
    profiler (``adam_count_main``) and by the kernel's own count, which
    must agree.  Returns the kernel's entry of the kernels line at these
    shapes."""
    model = build_model("uno9", device=dev, generator=torch.Generator().manual_seed(0),
                        **get_preset(PRESET).model_kwargs)
    ref = [torch.nn.Parameter(p.detach().clone()) for p in model.parameters()]
    opt = ComplexAdam(ref, lr=step_lr(1e-3, 100, 0.5, 4), weight_decay=1e-4)
    plain = [p.detach().clone() for p in model.parameters()]
    states = [_zero_state(p, False) for p in plain]
    group = opt.param_groups[0]
    g = torch.Generator(device=dev).manual_seed(2)
    for k in range(1, ADAM_STEPS + 1):
        for p in ref:
            p.grad = torch.randn(p.shape, dtype=p.dtype, device=dev, generator=g)
        adam_k.adam_plain(group, [adam_k.Slot(q, p.grad, s["exp_avg"], s["exp_avg_sq"], None, k)
                                  for p, q, s in zip(ref, plain, states)])
        opt.step()
    torch.cuda.synchronize()
    ulps = {"p": max(adam_k.ulps(p, q) for p, q in zip(ref, plain))}
    for key in ("exp_avg", "exp_avg_sq"):
        ulps[key] = max(adam_k.ulps(opt.state[p][key], s[key]) for p, s in zip(ref, states))
    for real in (True, False):
        ulps["p real" if real else "p complex"] = max(
            (adam_k.ulps(p, q) for p, q in zip(ref, plain) if p.is_complex() != real), default=0)
    plain_err = max(float((p.detach() - q).abs().max()) for p, q in zip(ref, plain))
    if max(ulps.values()) > ADAM_ULPS:
        raise AssertionError(f"[adam] the kernel against the plain sequence after "
                             f"{ADAM_STEPS} steps: ulps {ulps} (bound {ADAM_ULPS})")
    # the kernel alone: one step's table, packed once, launched ADAM_KERNEL_REPS times
    for p in ref:
        p.grad = torch.randn(p.shape, dtype=p.dtype, device=dev, generator=g)
    launches = adam_k.pack(group, opt._slots(group)[1], _build.device_limits(dev.index)[0])
    flush = torch.ones(256 * 2**20, dtype=torch.uint8, device=dev)  # 5x the 50 MB L2
    kernel_ms = statistics.median(_time_ms(lambda: adam_k.launch(launches, dev), flush,
                                           ADAM_KERNEL_REPS))
    plain_slots = [adam_k.Slot(q, p.grad, s["exp_avg"], s["exp_avg_sq"], None, ADAM_STEPS + 1)
                   for p, q, s in zip(ref, plain, states)]
    plain_ms = statistics.median(_time_ms(lambda: adam_k.adam_plain(group, plain_slots), flush,
                                          ADAM_KERNEL_REPS))
    n_cplx = sum(p.numel() for p in ref if p.is_complex())
    n_real = sum(p.numel() for p in ref if not p.is_complex())
    # read p, g, mu, nu and write p, mu, nu: 48 bytes a complex64 element, 28 an f32 one
    bound, by = _bound(48.0 * n_cplx + 28.0 * n_real, 0.0)
    timing = []
    for _ in range(ADAM_REPS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        opt.step()
        b.record()
        torch.cuda.synchronize()
        timing.append(a.elapsed_time(b))
    print(f"[adam] kernel {kernel_ms:.4f} ms a step (median of {ADAM_KERNEL_REPS} "
          f"launches, L2 flushed)  plain {plain_ms:.4f} ms (the torch ops, paced by the host)  "
          f"bound {bound:.4f} ms ({by}: {n_cplx} complex64 and {n_real} f32 numbers)  "
          f"{len(launches)} launch, {launches[0].blocks} blocks")
    # the profiler in a fresh process: a window this late in the script saw no kernel of
    # a step that launches only this one, though windows with torch kernels count it
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--adam-count"],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"[adam] the counting process exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    seen = json.loads(proc.stdout.strip().splitlines()[-1])["kernels"]
    host = statistics.median(_host_ms(opt.step) for _ in range(10))
    before = adam_k.LAUNCHES["step"]
    for _ in range(ADAM_COUNTED):
        opt.step()
    counted = adam_k.LAUNCHES["step"] - before
    if seen != ADAM_COUNTED or counted != ADAM_COUNTED:
        raise AssertionError(f"[adam] {ADAM_COUNTED} steps, {seen} kernels (profiler), "
                             f"{counted} launches (the kernel's count)")
    print(f"[adam] uno9 {PRESET} f32, {len(ref)} parameters ({n_cplx + n_real} numbers): ms "
          f"per optimizer step {_spread(timing)} (CUDA events, {len(timing)} steps); host to "
          f"host median {host:.3f}; kernels a step {seen / ADAM_COUNTED:g} (profiler, a fresh "
          f"process), {counted / ADAM_COUNTED:g} (the kernel's launches, this process); the "
          f"kernel against the plain sequence after {ADAM_STEPS} steps: largest gap in ulps "
          f"{ulps} (bound {ADAM_ULPS})")
    return dict(max_abs_err=plain_err, max_ulps=max(ulps.values()), ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound, bytes_ms=bound, flops_ms=0.0,
                library_ms=None)


def adam_count_main() -> int:
    """``[adam]``'s profiler count, in a fresh process: uno9's darcy_s211
    parameters on the card under ``ComplexAdam``, one warm step, then the
    kernels of ADAM_COUNTED steps in one window; prints them as a JSON
    line."""
    dev = torch.device("cuda", 0)
    model = build_model("uno9", device=dev, generator=torch.Generator().manual_seed(0),
                        **get_preset(PRESET).model_kwargs)
    g = torch.Generator(device=dev).manual_seed(2)
    params = [torch.nn.Parameter(p.detach().clone()) for p in model.parameters()]
    for p in params:
        p.grad = torch.randn(p.shape, dtype=p.dtype, device=dev, generator=g)
    opt = ComplexAdam(params, lr=step_lr(1e-3, 100, 0.5, 4), weight_decay=1e-4)
    opt.step()
    print(json.dumps({"kernels": _kernel_count(
        lambda: [opt.step() for _ in range(ADAM_COUNTED)])}))
    return 0


def main() -> int:
    t_start = time.perf_counter()
    phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    times = phase_kernels(dev)
    ns_times = phase_kernels(dev, NS_CMUL_SHAPES, NS_HEAD_SHAPE, "kernels ns2d")
    ns3d_times = phase_kernels(dev, NS3D_CMUL_SHAPES, None, "kernels ns3d")
    ns3d = get_preset(NS3D_PRESET)
    ns3d_times["remap"] = phase_remap(
        dev, _forecast_loss(dev, ns3d.model, ns3d.model_kwargs, BATCH, NS_S, ns3d.t_in, ns3d.t_f),
        f"{ns3d.model} f32 b{BATCH}", "kernels ns3d")[0]
    times["remap"], export_remap = phase_remap(dev, _darcy_step_loss(dev, "bfloat16"),
                                               f"uno9 bf16 b{BATCH}", "kernels")
    pieces_remap = phase_remap(dev, _darcy_step_loss(dev, "float32"),
                               f"uno9 f32 b{BATCH} (skips as channel pieces)", "kernels")[0]
    s421_times = phase_kernels(dev, S421_CMUL_SHAPES, S421_HEAD_SHAPE, "kernels s421")
    sr_times = phase_kernels(dev, SR_CMUL_SHAPES, SR_HEAD_SHAPE, "kernels s421 superres",
                             forward_only=True)
    oned_times = phase_kernels(dev, ONE_D_CMUL_SHAPES, None, "kernels 1d")
    dp_times = phase_kernels(dev, DP_CMUL_SHAPES, None, "kernels dp")
    dp_ns3d_times = phase_kernels(dev, DP_NS3D_CMUL_SHAPES, None, "kernels dp ns3d")
    tp_times = phase_kernels(dev, TP_CMUL_SHAPES, None, "kernels tp")
    spatial_times = phase_kernels(dev, CMUL_SHAPES, None, "kernels spatial")
    variant_times = phase_variant_kernels(dev)
    variant_times["ns3d_t40_256"]["remap"] = phase_remap(
        dev, _forecast_loss(dev, "uno3d_t40_256", NS3D_256_KW, NS3D_256_BATCH, NS3D_256_S,
                            *NS3D_256["uno3d_t40_256"]),
        f"uno3d_t40_256 f32 b{NS3D_256_BATCH}", "kernels ns3d-t40-256")[0]
    oned_times["remap"] = phase_remap(dev, _block_1d_loss(dev), "1-D OperatorBlock f32",
                                      "kernels 1d")[0]
    with tempfile.TemporaryDirectory() as tmp:
        fft_predict_ms = phase_predict(tmp)
        phase_head_switch(tmp)
        launches, fft_train_ms = phase_train(tmp, dev)
        remat_launches = phase_remat(tmp, dev)
        phase_dft(tmp, dev, fft_predict_ms, fft_train_ms)
        phase_generate(dev)
        phase_checkpoint(tmp, dev)
        phase_ns_generate(dev)
        phase_ns_predict(tmp)
        ns_launches, ns_train_ms = phase_ns_train(tmp, dev)
        ns3d_predict_ms = phase_ns3d_predict(tmp)
        ns3d_launches, ns3d_train_ms = phase_ns3d_train(tmp, dev)
        phase_dft3d(tmp, dev, ns3d_predict_ms, ns3d_train_ms)
        mat = phase_s421_generate(tmp)
        s421_launches, _ = phase_s421_train(mat, dev)
        phase_s421_predict(tmp, mat)
        sr_launches = phase_superres(tmp, dev, mat)
        dp_nccl_launches = phase_dp_nccl(tmp)
        mesh_launches = phase_dp(tmp, dev)
        export_launches = phase_export(tmp, dev)
        phase_profile(tmp)
        phase_custom_ops(tmp, dev, fft_predict_ms, ns_train_ms)
        variant_launches = {"s85": phase_s85(tmp, dev), **phase_ns3d_siblings(tmp, dev),
                            "s256": phase_s256(tmp, dev), "uno_p": phase_uno_p(tmp, dev),
                            "uno_demo": phase_uno_demo(tmp, dev)}
        variant_launches.update({k.replace("uno3d", "ns3d"): v
                                 for k, v in phase_ns3d_256(dev).items()})
    phase_grads_cpu_vs_cuda(dev)
    phase_cpu_vs_cuda(dev)
    set_dft_mode(True)
    try:
        phase_grads_cpu_vs_cuda(dev, "dft-cuda-vs-cpu")
        phase_cpu_vs_cuda(dev, "dft-cuda-vs-cpu")
    finally:
        set_dft_mode(None)
    phase_ns_cuda_vs_cpu(dev)
    phase_ns3d_cuda_vs_cpu(dev)
    phase_s421_cuda_vs_cpu(dev)
    oned_launches = phase_1d(dev)
    phase_variants_cuda_vs_cpu(dev)
    fused_launches = phase_fused_skips(dev)
    times["adam_step"] = phase_adam(dev)  # uno9's parameters: the Darcy paths'
    # top level: the Darcy path (darcy_s211 shapes, launches of its train
    # run); "ns2d", "ns3d", "s421" (darcy_s421: its train run), "superres"
    # (the super-resolution evaluation at 421, forward only) and "1d" (the
    # 1-D block's card check): the same keys at those paths' shapes; a
    # kernel not timed at a path's shapes has its launches there and on_path
    # (launched or not: the Adam kernel is timed at uno9's parameters, on the
    # paths with the Darcy shapes); "dp_nccl"
    # (the Darcy train run as one NCCL rank: the Darcy shapes), "dp" and
    # "dp_ns3d" (rank 0 of the two-rank runs, at B = 8), "export" (the
    # served artifact: the Darcy forward shapes), "remat" (the remat_blocks
    # run: the Darcy shapes), "tp" (rank 0 of the TP run, at the Co/2
    # shards), "spatial" and "spatial_ns3d" (rank 0 of the split runs: the
    # whole reduced modes, the Darcy and NS-3D shapes); then the variants'
    # paths (VARIANT_KERNELS: their shapes, the launches of their train runs);
    # "fused_skips": one f32 darcy_s211 step with the skips as channel pieces
    # (the Darcy contraction shapes; the head is not on the f32 path).  The
    # remap is timed at the Darcy step (bf16; its forward alone for
    # "export"), the f32 step with pieces ("fused_skips"), the 1-D block and
    # the NS-3D steps; the TP shards' remaps (f32 pieces, Co/2 on the
    # contraction's output side) are not timed at their shapes
    export_times = {k: times[k] for k in ("cmul_fwd", "mlp_head_fwd")}
    export_times["remap"] = export_remap
    paths = {"ns2d": (ns_times, ns_launches), "ns3d": (ns3d_times, ns3d_launches),
             "s421": (s421_times, s421_launches), "superres": (sr_times, sr_launches),
             "1d": (oned_times, oned_launches), "dp_nccl": (times, dp_nccl_launches),
             "dp": (dp_times, mesh_launches["dp"]),
             "dp_ns3d": (dp_ns3d_times, mesh_launches["dp_ns3d"]),
             "export": (export_times, export_launches), "remat": (times, remat_launches),
             "tp": (tp_times, mesh_launches["tp"]),
             "spatial": (spatial_times, mesh_launches["spatial"]),
             # the split path transforms its split axis by a partial DFT: no remap to time
             "spatial_ns3d": ({k: v for k, v in ns3d_times.items() if k != "remap"},
                              mesh_launches["spatial_ns3d"]),
             "fused_skips": ({**{k: times[k] for k in ("cmul_fwd", "cmul_bwd_x", "cmul_bwd_w")},
                              "remap": pieces_remap}, fused_launches),
             **{k: (variant_times[k], variant_launches[k]) for k in variant_times}}
    kernels = []
    for name, (_, _, src, rep) in KERNELS.items():
        entry = dict(name=name, route="cuda", source=src, replaces=rep,
                     launches=launches[name],
                     **(times[name] if name in times else dict(on_path=launches[name] > 0)))
        for path, (t, n) in paths.items():
            entry[path] = (dict(launches=n[name], **t[name]) if name in t
                           else dict(launches=n[name], on_path=n[name] > 0))
        kernels.append(entry)
    print(f"[total] chip_smoke.py ran {time.perf_counter() - t_start:.1f} s, the kernels' build "
          f"included")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_rank_main(*sys.argv[2:]))
    if sys.argv[1:2] == ["--adam-count"]:
        sys.exit(adam_count_main())
    sys.exit(main())
