"""Command-line entry point of the PyTorch port.

    python -m uno_tpu_torch.cli train --preset darcy_s211|darcy_s85|darcy_s421 \\
        (--data f.mat [g.mat ...] | --data-cache D.npz | --generate [--data-cache D.npz]) \\
        [--dtype bfloat16] [--device cuda] [--epochs N] [--log run.jsonl] \\
        [--checkpoint-dir CK [--checkpoint-every K] [--resume]] \\
        [--data-parallel] [--spatial N | --tensor-parallel N] \\
        [--profile-dir DIR] [--tensorboard DIR]
    python -m uno_tpu_torch.cli train --preset ns2d|ns2d_s256|ns3d_t40|ns3d_t20|ns3d_t10|ns3d_t9 \\
        (--data ns.mat | --data-cache D.npz | --generate [--gen-dt DT] [--gen-T T]) ...
    python -m uno_tpu_torch.cli predict --preset PRESET \\
        (--data ... | --data-cache D.npz | --generate ...) \\
        (--params P.npz | --init-seed N | --checkpoint-dir CK) \\
        --split test --out preds.npz [--dtype bfloat16] [--device cuda]
    python -m uno_tpu_torch.cli export --preset PRESET \\
        (--params P.npz | --init-seed N | --checkpoint-dir CK) --out model.pt2 \\
        [--serve-batch 16] [--dtype bfloat16] [--device cuda]
    python -m uno_tpu_torch.cli eval --preset PRESET \\
        (--data ... | --data-cache D.npz | --generate ...) --checkpoint-dir CK
    python -m uno_tpu_torch.cli generate --task darcy --out darcy.mat \\
        [--n 100] [--size 421] [--seed 0] [--device cuda]
    python -m uno_tpu_torch.cli generate --task ns --out ns.mat [--n 100] \\
        [--size 64] [--visc 1e-3] [--T 50] [--delta-t 1e-4] [--record-steps 50]

``PRESET`` is any of the nine presets of ``configs/presets.py``, ``uno_tpu``'s:
``darcy_s211`` (uno9), ``darcy_s85`` (uno9 at 85x85), ``darcy_s421`` (uno11),
``ns2d`` (uno), ``ns2d_s256`` (uno_s256 at 256x256), and ``ns3d_t40``,
``ns3d_t20``, ``ns3d_t10``, ``ns3d_t9`` (uno3d_t40/t20/t10/t9).

``train`` is the counterpart of ``uno_tpu``'s ``cli train`` for the Darcy,
NS-2D and NS-3D presets: it reads or writes the six-key split ``.npz``
(``--data-cache``) or reads ``.mat`` files (``--data``: for Darcy the
``coeff``/``sol`` fields, one file split first-n/last-n or several pooled
and permuted as the reference's multi-file recipe, ``data/loaders.py``;
for NS the generator's trajectories), draws the model's weights from the
preset's seed, and runs
``train.darcy.train_darcy``, ``train.ns2d.train_ns2d`` (the 40-step
rollout with full BPTT) or ``train.ns3d.train_ns3d`` (one 3-D forward from
the T_in window to all T_f steps), printing one JSON line per epoch and a
final test line.  With ``--checkpoint-dir`` it saves the best params and
the training state, and ``--resume`` continues from that state.
``--data-parallel`` makes the process one rank of a data-parallel run
(``uno_tpu_torch.parallel``): start one process per rank with torch's
launcher variables (``torchrun``, or ``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) or ``uno_tpu``'s
(``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``); the backend is
NCCL for ``--device cuda`` (each rank on ``cuda:LOCAL_RANK``) and gloo for
``--device cpu``; the global batch is ``--batch-size``, split evenly over
the ranks; rank 0 writes any data cache first, and alone logs and writes
checkpoints.  ``--spatial N`` splits the grid's leading axis over N ranks
(domain decomposition) and ``--tensor-parallel N`` shards every weight's
out-channel axis over N ranks (``uno_tpu_torch.parallel``); they are
mutually exclusive, both turn the fused head off, as ``uno_tpu``'s do, and
with ``--data-parallel`` the ranks form a (data x N) mesh, else N ranks in
all.  ``--profile-dir`` writes a ``torch.profiler`` trace of the
run there, ``--tensorboard`` a TensorBoard scalar per logged number.

``--generate`` makes the preset's split with the port's generators on
``--device``, from a ``torch.Generator`` seeded with the preset's seed:
Darcy in batches of 64 (``data/darcy_solver.py``); NS in batches of 20
(``data/grf.py`` ``GaussianRF`` and ``data/ns_solver.py``; NS-2D and NS-3D
alike) with ``uno_tpu``'s fast profile by default (``--gen-dt 1e-3``,
``--gen-T`` (T_in + T_f) / 2; ``--gen-dt 1e-4 --gen-T 50`` is the
reference's).  With ``--data-cache`` an
existing cache is loaded and a missing one is written.  A cache carries
``uno_tpu``'s six keys and its ``config_sig``, so a cache written by either
package loads in the other.  The two packages' generators draw the same law
from different random streams: for one seed they write different samples,
and held-out numbers of the two packages compare only on one cache file.

``predict`` is batch inference, the counterpart of ``uno_tpu``'s ``cli
predict``: it runs the preset's model over one split (for NS-2D the rollout
of T_f steps, fed zero targets as ``uno_tpu`` does; for NS-3D the one
forward to all T_f steps) and writes ``input``, ``pred`` and ``target`` to
``--out``, and prints the host time of each batch (``batch_ms``).  Weights
come from a checkpoint's best params, from an ``.npz`` param tree
(``uno_tpu_torch/bridge.py``), or are drawn from a seed.  ``export`` writes the
serving artifact of one input shape (``--serve-batch`` samples at the
preset's grid) through ``torch.export``, the weights baked in
(``uno_tpu_torch/export.py``); ``export.load_forward`` serves it.  ``eval``
reports a checkpoint's val and test rel-L2 (for NS-2D, per step and per trajectory;
for NS-3D, over the full field and per step).  ``generate --task darcy``
writes ``coeff`` and ``sol`` to a ``.mat`` file and prints its solve (ms,
CG iterations, final residual); ``generate --task ns``
writes ``a{i}`` (the initial vorticity), ``u{i}`` (the recorded
trajectory) and ``t{i}`` (its times) per batch of 20, compressed.

``UNO_TPU_TORCH_DFT=1`` runs the spectral transforms as partial-DFT matmuls
(``ops/spectral.py``) instead of FFTs, for the 2-D and the 3-D presets.
Every entry point turns TF32 and cuBLAS's reduced-precision bf16 reductions
off and states it in its output.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

_SPLIT_KEYS = ("train_a", "train_u", "val_a", "val_u", "test_a", "test_u")


_TRAIN_FLAGS = ("epochs", "batch_size", "learning_rate", "weight_decay", "seed")


def _build_preset(args):
    from uno_tpu_torch.configs.presets import PRESETS

    if args.preset not in PRESETS:
        raise SystemExit(f"{args.cmd}: preset {args.preset!r} is not ported (the port has "
                         f"{', '.join(PRESETS)})")
    preset = PRESETS[args.preset]
    train_over = {k: getattr(args, k) for k in _TRAIN_FLAGS
                  if getattr(args, k, None) is not None}
    data_over = {k: getattr(args, k) for k in ("ntrain", "nval", "ntest", "size")
                 if getattr(args, k, None) is not None}
    return dataclasses.replace(
        preset, train=dataclasses.replace(preset.train, **train_over), **data_over
    )


_NS_DT = 1e-3  # the fast profile's solver step


def _ns_horizon(preset, gen_T=None) -> float:
    """The NS generator's horizon: the fast profile's half a time unit per
    recorded frame unless ``--gen-T`` says otherwise."""
    return gen_T if gen_T is not None else (preset.t_in + preset.t_f) * 0.5


def _gen_sig(preset, gen_dt=None, gen_T=None) -> str:
    """The data-cache signature ``uno_tpu``'s cli writes for a preset."""
    dim = f"sub={preset.sub}" if preset.task == "darcy" else f"size={preset.size}"
    parts = [
        f"task={preset.task}", dim,
        f"ntrain={preset.ntrain}", f"nval={preset.nval}",
        f"ntest={preset.ntest}", f"seed={preset.train.seed}",
    ]
    if preset.task in ("ns2d", "ns3d"):
        dt = gen_dt if gen_dt is not None else _NS_DT
        parts += [f"t_in={preset.t_in}", f"t_f={preset.t_f}",
                  f"dt={dt:g}", f"T={_ns_horizon(preset, gen_T):g}"]
    return ",".join(parts)


def _cached(path, gen_fn, sig: str):
    """The six split arrays: loaded from ``path`` if it exists (a cache
    whose signature differs from the current config raises), else made by
    ``gen_fn`` and saved there, as ``uno_tpu``'s ``_cached`` does."""
    if path and os.path.exists(path):
        with np.load(path) as z:
            stored = str(z["config_sig"]) if "config_sig" in z.files else None
            if stored is None:
                print(f"warning: data cache {path} predates config signatures; "
                      f"assuming it matches {sig!r}")
            elif stored != sig:
                raise SystemExit(
                    f"data cache {path} was generated with a different config:\n"
                    f"  cache:   {stored}\n  current: {sig}\n"
                    "delete the cache or point --data-cache elsewhere"
                )
            return tuple(z[k] for k in _SPLIT_KEYS)
    if gen_fn is None:
        raise SystemExit(f"data cache {path} not found: pass --generate to write it")
    data = gen_fn()
    if path:
        np.savez(path, **dict(zip(_SPLIT_KEYS, data)), config_sig=np.asarray(sig))
    return data


def _gen_darcy(preset, device):
    """The preset's split from the port's Darcy generator, as ``uno_tpu``'s
    ``_gen_darcy`` lays it out: s = 421 subsampled by ``sub``, batches of
    64, train then val then test."""
    from uno_tpu_torch.data.darcy_solver import generate_darcy_batch

    s = int((421 - 1) / preset.sub) + 1
    n = preset.ntrain + preset.nval + preset.ntest
    gen = torch.Generator().manual_seed(preset.train.seed)
    bs = max(1, min(64, n))
    a_list, p_list = [], []
    for done in range(0, n, bs):
        a, p = generate_darcy_batch(gen, min(bs, n - done), s, device=device)
        a_list.append(a.cpu().numpy())
        p_list.append(p.cpu().numpy())
    a = np.concatenate(a_list)[..., None]
    p = np.concatenate(p_list)
    i1 = preset.ntrain
    i2 = i1 + preset.nval
    return (a[:i1], p[:i1], a[i1:i2], p[i1:i2], a[i2:], p[i2:])


_NS_GEN_BATCH = 20  # trajectories per solver run (the reference's generation batch)


def _ns_trajectories(gen, n, s, device, visc, T, delta_t, record_steps):
    """NS trajectories from the port's generator on ``device``, in batches
    of up to 20: ``(w0, sol, sol_t)`` per batch, ``w0`` drawn from ``gen``."""
    from uno_tpu_torch.data.grf import GaussianRF
    from uno_tpu_torch.data.ns_solver import default_forcing, navier_stokes_2d

    grf = GaussianRF(2, s, alpha=2.5, tau=7.0)
    f = default_forcing(s, device)
    for done in range(0, n, _NS_GEN_BATCH):
        w0 = grf.sample(gen, min(_NS_GEN_BATCH, n - done), device=device)
        yield (w0, *navier_stokes_2d(w0, f, visc=visc, T=T, delta_t=delta_t,
                                     record_steps=record_steps))


def _gen_ns(preset, device, gen_dt=None, gen_T=None):
    """The preset's NS split from the port's generator, as ``uno_tpu``'s
    ``_gen_ns`` lays it out: batches of 20 trajectories of T_in + T_f
    recorded frames, the first T_in the input and the next T_f the target,
    train then val then test."""
    n = preset.ntrain + preset.nval + preset.ntest
    frames = preset.t_in + preset.t_f
    batches = _ns_trajectories(
        torch.Generator().manual_seed(preset.train.seed), n, preset.size, device, visc=1e-3,
        T=_ns_horizon(preset, gen_T), delta_t=gen_dt if gen_dt is not None else _NS_DT,
        record_steps=frames)
    sols = [sol.cpu().numpy() for _, sol, _ in batches]
    a = np.concatenate([sol[..., : preset.t_in] for sol in sols])
    u = np.concatenate([sol[..., preset.t_in : frames] for sol in sols])
    i1, i2 = preset.ntrain, preset.ntrain + preset.nval
    return (a[:i1], u[:i1], a[i1:i2], u[i1:i2], a[i2:], u[i2:])


def _load_ns_mat(path, preset):
    """The preset's split from a generator ``.mat`` file, as ``uno_tpu``'s
    cli reads it: train and val from the first ntrain + nval trajectories,
    test from the rest, resized to the preset's grid."""
    from uno_tpu_torch.data.loaders import load_navier_stokes

    ta, tu, sa, su = load_navier_stokes(
        path, train=preset.ntrain + preset.nval, test=preset.ntest,
        sample_num=preset.ntrain + preset.nval + preset.ntest,
        t_in=preset.t_in, t_out=preset.t_f, size=preset.size,
    )
    i1 = preset.ntrain
    return (ta[:i1], tu[:i1], ta[i1:], tu[i1:], sa, su)


def _load_darcy_mat(paths, preset):
    """The preset's split from Darcy ``.mat`` files, as ``uno_tpu``'s cli
    reads them: one file gives train and val from its first ntrain + nval
    samples and test from its last ntest; two or more go through the
    reference's multi-file recipe, permuted by the preset's seed."""
    from uno_tpu_torch.data.loaders import load_darcy, load_darcy_multi

    if len(paths) > 1:
        return load_darcy_multi(paths, preset.ntrain, preset.nval, preset.ntest,
                                sub=preset.sub, seed=preset.train.seed)
    xt, yt, xs, ys = load_darcy(preset.sub, preset.ntrain + preset.nval, preset.ntest,
                                paths[0])
    i1 = preset.ntrain
    return (xt[:i1], yt[:i1], xt[i1:], yt[i1:], xs, ys)


def _load_data(args, preset, device):
    """The preset's six-array split from ``--data``, ``--data-cache`` and
    ``--generate``, the same way for train, predict and eval."""
    if args.data and not args.generate:
        if preset.task == "darcy":
            return _load_darcy_mat(args.data, preset)
        return _load_ns_mat(args.data[0], preset)
    if not args.generate and not args.data_cache:
        raise SystemExit("pass --data-cache with a split npz, or --generate")
    gen_fn = None
    if args.generate and preset.task == "darcy":
        gen_fn = lambda: _gen_darcy(preset, device)  # noqa: E731
    elif args.generate:
        gen_fn = lambda: _gen_ns(preset, device, args.gen_dt, args.gen_T)  # noqa: E731
    return _cached(args.data_cache, gen_fn, _gen_sig(preset, args.gen_dt, args.gen_T))


def _restore_best(model, directory: str) -> None:
    """Load a checkpoint's ``best_params`` into ``model``."""
    from uno_tpu_torch.train.checkpoint import CheckpointManager

    ckpt = CheckpointManager(directory)
    if not ckpt.exists("best_params"):
        raise SystemExit(
            f"no best_params checkpoint under {directory}: was the run trained "
            "with --checkpoint-dir and at least one validation pass?"
        )
    model.load_state_dict(ckpt.restore("best_params"))


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: torch.cuda.is_available() is false "
            "(pass --device cpu to run on the CPU)"
        )
    return dev


def _no_tf32() -> None:
    """Full-f32 matmuls and convolutions on the card (both default to TF32
    in some torch versions), and bf16 products accumulated in f32 (cuBLAS
    may otherwise reduce split sums in bf16); stated in the output."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _precision_report() -> dict:
    from uno_tpu_torch.ops.kernels.mlp_head import fused_head_enabled
    from uno_tpu_torch.ops.spectral import _dft_enabled

    return {
        "spectral": "dft" if _dft_enabled() else "fft",
        "fused_head": fused_head_enabled(),
        "allow_tf32": {"cuda.matmul": torch.backends.cuda.matmul.allow_tf32,
                       "cudnn": torch.backends.cudnn.allow_tf32},
        "allow_bf16_reduced_precision_reduction":
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
    }


def _model(args, preset, device, seed=None):
    from uno_tpu_torch.models import build_model

    gen = torch.Generator().manual_seed(preset.train.seed if seed is None else seed)
    return build_model(preset.model, dtype=args.dtype, device=device, generator=gen,
                       **preset.model_kwargs)


class _Tee:
    """Write metric JSONL to both stdout and an append-mode file."""

    def __init__(self, path):
        self._file = open(path, "a")

    def write(self, s):
        self._file.write(s)
        sys.stdout.write(s)

    def flush(self):
        self._file.flush()
        sys.stdout.flush()

    def close(self):
        self._file.close()


def cmd_train(args) -> int:
    """Train a Darcy, NS-2D or NS-3D preset's model; JSONL metrics."""
    import torch.distributed as dist

    from uno_tpu_torch.ops.kernels import mlp_head
    from uno_tpu_torch.train.darcy import train_darcy
    from uno_tpu_torch.train.metrics import MetricLogger
    from uno_tpu_torch.train.ns2d import train_ns2d
    from uno_tpu_torch.train.ns3d import train_ns3d
    from uno_tpu_torch.train.common import barrier
    from uno_tpu_torch.utils.profiling import trace

    device = _device(args.device)
    _no_tf32()
    preset = _build_preset(args)
    if args.checkpoint_dir:
        preset = dataclasses.replace(preset, train=dataclasses.replace(
            preset.train, checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every, resume=args.resume))
    elif args.resume:
        raise SystemExit("train --resume needs --checkpoint-dir")
    if args.tensorboard:
        preset = dataclasses.replace(preset, train=dataclasses.replace(
            preset.train, log_tensorboard=args.tensorboard))
    if args.tensor_parallel > 1 and args.spatial > 1:
        raise SystemExit("--tensor-parallel and --spatial are mutually exclusive: both place "
                         "work on the 'spatial' mesh axis (weights vs grid)")
    n_model = max(args.spatial, args.tensor_parallel)
    if args.tensor_parallel > 1:
        preset = dataclasses.replace(preset, train=dataclasses.replace(
            preset.train, tensor_parallel=True))
    dp, owns_group = None, False
    if args.data_parallel or n_model > 1:
        from uno_tpu_torch.parallel import initialize_from_env, make_mesh

        owns_group = not dist.is_initialized()
        initialize_from_env("nccl" if device.type == "cuda" else "gloo")
        dp = make_mesh(n_data=None if args.data_parallel else 1, n_spatial=n_model,
                       device=device)
        device = dp.device
    main = dp is None or dp.main
    tee = _Tee(args.log) if args.log and main else None
    logger = None
    head_mode = mlp_head._FUSED_HEAD_MODE
    try:
        if n_model > 1:
            # as uno_tpu/cli.py:357-363; under TP the model takes the unfused
            # head whatever the switch says (fc1's hidden axis is sharded)
            mlp_head.set_fused_head_mode(False)
        if not main:
            barrier(dp)  # rank 0 writes a missing data cache first
        data = _load_data(args, preset, device)
        if main:
            barrier(dp)
        model = _model(args, preset, device)
        if main:  # only rank 0 prints and logs
            print(f"precision {json.dumps(_precision_report())}")
            logger = MetricLogger(tee, tensorboard_dir=preset.train.log_tensorboard)
        with trace(args.profile_dir):
            if preset.task == "darcy":
                train_darcy(model, *data, preset.train, logger=logger, dp=dp)
            else:
                trainer = train_ns2d if preset.task == "ns2d" else train_ns3d
                trainer(model, *data, preset.train, t_f=preset.t_f, logger=logger, dp=dp)
    finally:
        mlp_head.set_fused_head_mode(head_mode)
        if logger is not None:
            logger.close()
        if tee is not None:
            tee.close()
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()
    return 0


def _load_weights(model, args) -> None:
    """``--params`` or ``--checkpoint-dir`` into ``model`` (``--init-seed``:
    the weights it was built with)."""
    from uno_tpu_torch.bridge import load_npz, params_from_flax

    if args.params:
        params_from_flax(model, load_npz(args.params))
    elif args.checkpoint_dir:
        _restore_best(model, args.checkpoint_dir)


def cmd_predict(args) -> int:
    """Batch inference over one split; writes (input, pred, target)."""
    device = _device(args.device)
    _no_tf32()
    preset = _build_preset(args)
    data = _load_data(args, preset, device)
    split = {"train": 0, "val": 2, "test": 4}[args.split]
    a, u = data[split], data[split + 1]

    model = _model(args, preset, device, seed=args.init_seed)
    _load_weights(model, args)
    model.eval()

    if preset.task == "darcy":
        s = u.shape[1]
        fwd = lambda xb: model(xb.float()).reshape(xb.shape[0], s, s)  # noqa: E731
    elif preset.task == "ns3d":
        from uno_tpu_torch.train.ns3d import forecast

        fwd = lambda xb: forecast(model, xb, preset.t_f)  # noqa: E731
    else:
        from uno_tpu_torch.train.ns2d import make_rollout

        rollout = make_rollout(model, preset.t_f)

        def fwd(xb):
            # the rollout needs targets only for its loss: zeros, as in uno_tpu
            return rollout(xb, torch.zeros(xb.shape[:3] + (preset.t_f,), device=device))[1]
    bs = preset.train.batch_size
    preds, batch_ms = [], []
    with torch.inference_mode():
        for i in range(0, len(a), bs):
            t0 = time.perf_counter()
            xb = torch.from_numpy(np.ascontiguousarray(a[i : i + bs])).to(device)
            preds.append(fwd(xb).cpu().numpy())  # the copy to host waits for the card
            batch_ms.append((time.perf_counter() - t0) * 1e3)
    pred = np.concatenate(preds) if preds else np.zeros((0,))
    np.savez(args.out, input=a, pred=pred, target=u)
    print(f"wrote {args.out}: pred {pred.shape} ({args.split} split)")
    print(json.dumps({
        "predict": preset.name, "model": preset.model,
        "dtype": model.spec.dtype, "device": str(device),
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "batch_size": bs, "n": int(len(a)), "batch_ms": batch_ms, **_precision_report(),
    }))
    return 0


def _serve_shape(preset, args) -> tuple:
    """The model's input shape for ``--serve-batch`` samples, as ``uno_tpu``'s
    ``cmd_export`` has it: Darcy (B, S, S, 1) at the preset's subsampled
    421 grid, NS-2D (B, S, S, T_in), NS-3D (B, S, S, T_in, 1); ``--size``
    sets S."""
    b = args.serve_batch
    if preset.task == "darcy":
        s = args.size or int((421 - 1) / preset.sub) + 1
        return (b, s, s, 1)
    s = args.size or preset.size
    return (b, s, s, preset.t_in) + ((1,) if preset.task == "ns3d" else ())


def cmd_export(args) -> int:
    """The forward at one serving shape as a ``torch.export`` artifact with
    the weights baked in (``uno_tpu_torch/export.py``)."""
    from uno_tpu_torch.export import export_forward

    device = _device(args.device)
    _no_tf32()
    preset = _build_preset(args)
    model = _model(args, preset, device, seed=args.init_seed)
    _load_weights(model, args)
    sample = torch.zeros(_serve_shape(preset, args), device=device)
    t0 = time.perf_counter()
    data = export_forward(model, sample, path=args.out)
    print(f"wrote {args.out}: {len(data) / 1e6:.1f} MB torch.export artifact for input "
          f"{tuple(sample.shape)}")
    print(json.dumps({
        "export": preset.name, "model": preset.model, "dtype": model.spec.dtype,
        "device": str(device), "input": list(sample.shape), "bytes": len(data),
        "seconds": time.perf_counter() - t0, **_precision_report(),
    }))
    return 0


def cmd_eval(args) -> int:
    """A checkpoint's best params on the preset's val and test splits."""
    from uno_tpu_torch.train.evaluate import evaluate_darcy, evaluate_ns2d, evaluate_ns3d

    device = _device(args.device)
    _no_tf32()
    preset = _build_preset(args)
    _, _, val_a, val_u, test_a, test_u = _load_data(args, preset, device)
    model = _model(args, preset, device)
    _restore_best(model, args.checkpoint_dir)
    model.eval()
    out = {"task": preset.task, "preset": preset.name, "checkpoint": args.checkpoint_dir}
    bs = preset.train.batch_size
    for split, a, u in (("val", val_a, val_u), ("test", test_a, test_u)):
        if not len(a):
            continue
        if preset.task == "darcy":
            out[f"{split}_rel_l2"] = evaluate_darcy(model, a, u, bs)
        elif preset.task == "ns2d":
            r = evaluate_ns2d(model, a, u, preset.t_f, bs)
            out[f"{split}_step_rel_l2"] = r["step_rel_l2"]
            out[f"{split}_traj_rel_l2"] = r["traj_rel_l2"]
        else:
            r = evaluate_ns3d(model, a, u, preset.t_f, bs)
            out[f"{split}_field_rel_l2"] = r["field_rel_l2"]
            out[f"{split}_step_rel_l2"] = r["step_rel_l2"]
    out.update(_precision_report())
    line = json.dumps(out)
    print(line)
    if args.log:
        with open(args.log, "a") as f:
            f.write(line + "\n")
    return 0


def cmd_generate(args) -> int:
    """Darcy (coefficient, solution) pairs, or NS trajectories in batches of
    20, to a ``.mat`` file."""
    import scipy.io

    device = _device(args.device)
    _no_tf32()
    gen = torch.Generator().manual_seed(args.seed)
    if args.task == "darcy":
        from uno_tpu_torch.data.darcy_solver import generate_darcy_batch

        info = {}
        t0 = time.perf_counter()
        a, p = generate_darcy_batch(gen, args.n, args.size or 421, device=device, info=info)
        a, p = a.cpu().numpy(), p.cpu().numpy()  # the copy to host waits for the solve
        ms = (time.perf_counter() - t0) * 1e3
        scipy.io.savemat(args.out, {"coeff": a, "sol": p})
        print(json.dumps({"generate": "darcy", "n": args.n, "size": args.size or 421,
                          "device": str(device), "ms": ms, "cg_iterations": info["iterations"],
                          "residual": info["residual"]}))
    else:
        mdict = {}
        batches = _ns_trajectories(gen, args.n, args.size or 64, device, visc=args.visc,
                                   T=args.T, delta_t=args.delta_t,
                                   record_steps=args.record_steps)
        for i, (w0, sol, sol_t) in enumerate(batches):
            mdict[f"a{i}"] = w0.cpu().numpy()
            mdict[f"u{i}"] = sol.cpu().numpy()
            mdict[f"t{i}"] = sol_t.numpy()
        scipy.io.savemat(args.out, mdict, do_compression=True)
    print(f"wrote {args.out}")
    return 0


def _add_model_args(p: argparse.ArgumentParser) -> None:
    """The preset's model, its dtype and the device."""
    p.add_argument("--preset", required=True)
    p.add_argument("--size", type=int, default=None, help="NS presets: the grid")
    p.add_argument("--device", default="cuda",
                   help="torch device; a missing CUDA device raises")
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                   help="compute dtype (bf16 mixed-precision policy: params, "
                        "optimizer and loss stay f32)")
    p.add_argument("--seed", type=int, default=None,
                   help="the preset's seed: weights, batch order, the "
                        "generator and the data-cache signature")


def _add_weight_source(p: argparse.ArgumentParser) -> None:
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--params", help="npz param tree (uno_tpu_torch.bridge)")
    src.add_argument("--init-seed", type=int,
                     help="draw random weights from this seed instead")
    src.add_argument("--checkpoint-dir", help="a training run's best params")


def _add_data_args(p: argparse.ArgumentParser) -> None:
    """The preset, its split and the device: common to train, predict and eval."""
    _add_model_args(p)
    p.add_argument("--data", default=None, nargs="+",
                   help="Darcy presets: .mat files of coeff and sol on the 421 grid (one: "
                        "first ntrain+nval / last ntest; several: the reference's pooled, "
                        "seeded multi-file split); NS presets: the generator's .mat file "
                        "(a{i}, u{i} per batch of 20), the first is read")
    p.add_argument("--data-cache", default=None,
                   help="six-key split npz (uno_tpu's or the port's); with "
                        "--generate it is written if missing")
    p.add_argument("--generate", action="store_true",
                   help="make the split with the port's generators on --device")
    p.add_argument("--gen-dt", type=float, default=None,
                   help="NS generation solver step (default 1e-3, the fast profile; "
                        "the reference generator uses 1e-4)")
    p.add_argument("--gen-T", type=float, default=None,
                   help="NS generation horizon in time units (default "
                        "(t_in+t_f)*0.5; the reference uses 50)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--ntrain", type=int, default=None)
    p.add_argument("--nval", type=int, default=None)
    p.add_argument("--ntest", type=int, default=None)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="uno_tpu_torch", formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog="Not ported yet, with the ROADMAP.md item that brings it:\n"
               "  bench                      the benchmark queue's item 2 (the H100 benchmark)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="train a Darcy, NS-2D or NS-3D preset's model")
    _add_data_args(p)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--weight-decay", type=float, default=None)
    p.add_argument("--checkpoint-dir", default=None,
                   help="save best_params and train_state here")
    p.add_argument("--checkpoint-every", type=int, default=1,
                   help="epochs between train_state saves (with --checkpoint-dir); "
                        "best params are saved on every improvement")
    p.add_argument("--resume", action="store_true",
                   help="continue from --checkpoint-dir's train_state")
    p.add_argument("--log", default=None,
                   help="append metric JSONL to this file (also printed to stdout)")
    p.add_argument("--data-parallel", action="store_true",
                   help="run as one rank of a data-parallel job: one process per rank, "
                        "started with torchrun's variables (MASTER_ADDR, MASTER_PORT, "
                        "WORLD_SIZE, RANK, LOCAL_RANK) or uno_tpu's (COORDINATOR_ADDRESS, "
                        "NUM_PROCESSES, PROCESS_ID); NCCL on cuda, gloo on cpu")
    p.add_argument("--spatial", type=int, default=1, metavar="N",
                   help="split the grid's leading axis over N ranks (domain decomposition; "
                        "with --data-parallel the mesh is data x spatial)")
    p.add_argument("--tensor-parallel", type=int, default=1, metavar="N",
                   help="channel tensor parallelism: shard every weight's out-channel axis "
                        "over N ranks (mutually exclusive with --spatial: both use the "
                        "'spatial' mesh axis)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of the run here")
    p.add_argument("--tensorboard", default=None,
                   help="write each logged number as a TensorBoard scalar here")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("predict", help="batch inference over a data split")
    _add_data_args(p)
    _add_weight_source(p)
    p.add_argument("--split", default="test", choices=["train", "val", "test"])
    p.add_argument("--out", required=True, help="output npz path")
    p.set_defaults(fn=cmd_predict)

    p = sub.add_parser("export", help="the serving artifact of one input shape")
    _add_model_args(p)
    _add_weight_source(p)
    p.add_argument("--out", required=True, help="artifact output path")
    p.add_argument("--serve-batch", type=int, default=1,
                   help="batch size of the serving shape")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("eval", help="a checkpoint's val and test rel-L2")
    _add_data_args(p)
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--log", default=None, help="append the result line to this file")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("generate", help="Darcy or NS-2D data to a .mat file")
    p.add_argument("--task", choices=["darcy", "ns"], required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=100)
    p.add_argument("--size", type=int, default=None, help="grid (default 421 Darcy, 64 NS)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--visc", type=float, default=1e-3, help="NS viscosity")
    p.add_argument("--T", type=float, default=50.0, help="NS horizon in time units")
    p.add_argument("--delta-t", type=float, default=1e-4, help="NS solver step")
    p.add_argument("--record-steps", type=int, default=50, help="NS frames recorded")
    p.add_argument("--device", default="cuda",
                   help="torch device; a missing CUDA device raises")
    p.set_defaults(fn=cmd_generate)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
