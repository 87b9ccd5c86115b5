"""Command-line entry point of the PyTorch port.

    python -m uno_tpu_torch.cli train --preset darcy_s211 --data-cache D.npz \\
        [--dtype bfloat16] [--device cuda] [--epochs N] [--log run.jsonl]
    python -m uno_tpu_torch.cli predict --preset darcy_s211 \\
        --data-cache D.npz (--params P.npz | --init-seed N) \\
        --split test --out preds.npz [--dtype bfloat16] [--device cuda]

``train`` is the counterpart of ``uno_tpu``'s ``cli train`` for the Darcy
presets: it reads the six-key split ``.npz`` that ``uno_tpu``'s
``--data-cache`` writes, draws the model's weights from the preset's seed,
and runs ``train.darcy.train_darcy``, printing one JSON line per epoch and a
final ``test_rel_l2`` line.

``predict`` is batch inference, the counterpart of ``uno_tpu``'s ``cli
predict``: it reads the six-key split ``.npz`` that ``uno_tpu``'s
``--data-cache`` writes, runs the preset's model over one split, and writes
``input``, ``pred`` and ``target`` to ``--out``.  Weights come from an
``.npz`` param tree (``uno_tpu_torch/bridge.py``) or are drawn from a seed.
The port has no data generator and no Orbax checkpoint restore yet.
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
    from uno_tpu_torch.configs.presets import get_preset

    preset = get_preset(args.preset)
    train_over = {k: getattr(args, k) for k in _TRAIN_FLAGS
                  if getattr(args, k, None) is not None}
    data_over = {k: getattr(args, k) for k in ("ntrain", "nval", "ntest")
                 if getattr(args, k) is not None}
    return dataclasses.replace(
        preset, train=dataclasses.replace(preset.train, **train_over), **data_over
    )


def _gen_sig(preset) -> str:
    """The data-cache signature ``uno_tpu``'s cli writes for a Darcy preset."""
    return ",".join([
        f"task={preset.task}", f"sub={preset.sub}",
        f"ntrain={preset.ntrain}", f"nval={preset.nval}",
        f"ntest={preset.ntest}", f"seed={preset.train.seed}",
    ])


def _load_split_cache(path: str, sig: str):
    """The six split arrays of a ``--data-cache`` npz; a cache whose
    signature differs from the current config raises."""
    if not os.path.exists(path):
        raise SystemExit(
            f"data cache {path} not found: the port has no data generator yet; "
            "write one with `python -m uno_tpu.cli train --generate --data-cache`"
        )
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
    in some torch versions); stated in the output."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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
    """Train a Darcy preset's model on a split cache; JSONL metrics."""
    from uno_tpu_torch.models import build_model
    from uno_tpu_torch.train.darcy import train_darcy
    from uno_tpu_torch.train.metrics import MetricLogger

    device = _device(args.device)
    _no_tf32()
    preset = _build_preset(args)
    if preset.task != "darcy":
        raise SystemExit(f"train: only Darcy presets are ported, not {preset.task}")
    data = _load_split_cache(args.data_cache, _gen_sig(preset))
    gen = torch.Generator().manual_seed(preset.train.seed)
    model = build_model(preset.model, dtype=args.dtype, device=device,
                        generator=gen, **preset.model_kwargs)
    tee = _Tee(args.log) if args.log else None
    try:
        train_darcy(model, *data, preset.train, logger=MetricLogger(tee))
    finally:
        if tee is not None:
            tee.close()
    return 0


def cmd_predict(args) -> int:
    """Batch inference over one split; writes (input, pred, target)."""
    from uno_tpu_torch.bridge import load_npz, params_from_flax
    from uno_tpu_torch.models import build_model

    device = _device(args.device)
    _no_tf32()
    preset = _build_preset(args)
    if preset.task != "darcy":
        raise SystemExit(f"predict: only Darcy presets are ported, not {preset.task}")
    data = _load_split_cache(args.data_cache, _gen_sig(preset))
    split = {"train": 0, "val": 2, "test": 4}[args.split]
    a, u = data[split], data[split + 1]

    gen = torch.Generator().manual_seed(
        args.init_seed if args.init_seed is not None else preset.train.seed
    )
    model = build_model(preset.model, dtype=args.dtype, device=device,
                        generator=gen, **preset.model_kwargs)
    if args.params:
        params_from_flax(model, load_npz(args.params))
    model.eval()

    s = u.shape[1]
    bs = preset.train.batch_size
    preds, batch_ms = [], []
    with torch.inference_mode():
        for i in range(0, len(a), bs):
            t0 = time.perf_counter()
            xb = torch.from_numpy(np.ascontiguousarray(a[i : i + bs])).to(device)
            out = model(xb.float()).reshape(xb.shape[0], s, s)
            preds.append(out.cpu().numpy())  # the copy to host waits for the card
            batch_ms.append((time.perf_counter() - t0) * 1e3)
    pred = np.concatenate(preds) if preds else np.zeros((0,))
    np.savez(args.out, input=a, pred=pred, target=u)
    print(f"wrote {args.out}: pred {pred.shape} ({args.split} split)")
    print(json.dumps({
        "predict": preset.name, "model": preset.model,
        "dtype": model.spec.dtype, "device": str(device),
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "batch_size": bs, "n": int(len(a)), "batch_ms": batch_ms,
        "allow_tf32": {"cuda.matmul": torch.backends.cuda.matmul.allow_tf32,
                       "cudnn": torch.backends.cudnn.allow_tf32},
    }))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="uno_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser(
        "train", help="train a Darcy preset's model on a split cache",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog="Not ported yet, with the ROADMAP.md item that brings each:\n"
               "  --generate, --data         Queue 1 item 9 (data generators, loaders)\n"
               "  --checkpoint-dir, --resume Queue 1 item 4 (checkpoints)\n"
               "  --data-parallel, --spatial, --tensor-parallel\n"
               "                             Queue 1 item 8 (parallel/)",
    )
    p.add_argument("--preset", required=True)
    p.add_argument("--data-cache", required=True,
                   help="six-key split npz written by uno_tpu's --data-cache")
    p.add_argument("--device", default="cuda",
                   help="torch device; a missing CUDA device raises")
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                   help="compute dtype (bf16 mixed-precision policy: params, "
                        "optimizer and loss stay f32)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--weight-decay", type=float, default=None)
    p.add_argument("--ntrain", type=int, default=None)
    p.add_argument("--nval", type=int, default=None)
    p.add_argument("--ntest", type=int, default=None)
    p.add_argument("--seed", type=int, default=None,
                   help="the preset's seed: weights, batch order and the "
                        "data-cache signature")
    p.add_argument("--log", default=None,
                   help="append metric JSONL to this file (also printed to stdout)")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("predict", help="batch inference over a data split")
    p.add_argument("--preset", required=True)
    p.add_argument("--data-cache", required=True,
                   help="six-key split npz written by uno_tpu's --data-cache")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--params", help="npz param tree (uno_tpu_torch.bridge)")
    src.add_argument("--init-seed", type=int,
                     help="draw random weights from this seed instead")
    p.add_argument("--split", default="test", choices=["train", "val", "test"])
    p.add_argument("--out", required=True, help="output npz path")
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                   help="compute dtype (bf16 mixed-precision policy)")
    p.add_argument("--device", default="cuda",
                   help="torch device; a missing CUDA device raises")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--seed", type=int, default=None,
                   help="the preset's seed (part of the data-cache signature)")
    p.add_argument("--ntrain", type=int, default=None)
    p.add_argument("--nval", type=int, default=None)
    p.add_argument("--ntest", type=int, default=None)
    p.set_defaults(fn=cmd_predict)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
