"""What the traffic drivers share: the run's context, the program's model
built from a configuration (checked by its family's ``check_spec``), and
the comparisons that decide ``correct``."""

from __future__ import annotations

import gc
import statistics
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from benchmark import plugins

# the configuration keys the harness itself reads; the model family
# (``plugins.family``) declares the rest
CONFIG_KEYS = {"name", "source", "about", "reduced", "assumed", "task", "reference", "program",
               "model", "optimizer", "data"}


@dataclass
class Context:
    cfg: dict            # the configuration file
    traffic: dict        # the traffic mix's file
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    chips: int = 1
    dp: Any = None       # the program's DataParallel rank, on more than one chip
    mode: str = "program"  # "program", "control", or "fault:<name>"
    t0: float = 0.0      # the process's start on the host clock

    @property
    def main(self) -> bool:
        return self.dp is None or self.dp.rank == 0


def phase(ctx: "Context", what: str) -> None:
    """The set-up's progress on standard error, seconds since the start."""
    import sys
    import time

    print(f"setup {what}: {time.perf_counter() - ctx.t0:.3f} s", file=sys.stderr, flush=True)


def set_precision() -> None:
    """The program's precision flags, as its command line sets them: full
    float32 products, bf16 products accumulated in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def program_model(cfg: dict, weights: Dict[str, torch.Tensor], device) -> torch.nn.Module:
    """The program's model for the configuration, holding ``weights``."""
    from uno_tpu_torch.models import build_model

    prog = cfg["program"]
    model = build_model(prog["model"], dtype=prog["dtype"], device=device,
                        generator=torch.Generator().manual_seed(0), **prog["kwargs"])
    plugins.family(cfg).check_spec(model.spec, cfg["model"])
    model.load_state_dict(weights, strict=True)
    return model


def release(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def _norm(t: torch.Tensor) -> float:
    return float(t.to(torch.complex128 if t.is_complex() else torch.float64).norm())


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: Optional[List[str]] = None) -> List[float]:
    """Each leaf's gap between the two sides' norms, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    keep = list(ref) if keep is None else keep
    rn = {k: _norm(ref[k]) for k in keep}
    med = statistics.median(rn.values())
    return [abs(_norm(prog[k]) - rn[k]) / max(rn[k], med) for k in keep]


def sample_gaps(out: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each sample's L2 distance from the reference."""
    b = ref.shape[0]
    return (out.reshape(b, -1).double() - ref.reshape(b, -1).double()).norm(dim=1)



def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Any]:
    """Each number beside its limit, and whether every one is within it."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(c["value"] == c["value"] and c["value"] <= c["limit"] for c in checks.values())
    return {"correct": ok, "checks": checks}


class HostLoad:
    """The host's state over the window, printed on standard error: the
    load average, the share of the machine's CPU time its hypervisor stole,
    this process's CPU time and involuntary switches, and the cores its
    main thread was on at both ends.  Not a metric: it tells a run whose
    host was busy from one whose program changed."""

    def __init__(self):
        self.a = self._read()

    @staticmethod
    def _read() -> dict:
        import os
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF)
        out = {"cpu_s": ru.ru_utime + ru.ru_stime, "switches": ru.ru_nivcsw}
        try:
            with open("/proc/stat") as f:
                ticks = [int(v) for v in f.readline().split()[1:]]
            out["steal"], out["ticks"] = (ticks[7] if len(ticks) > 7 else 0), sum(ticks[:8])
            with open("/proc/loadavg") as f:
                out["load"] = float(f.read().split()[0])
            with open("/proc/self/stat") as f:
                out["core"] = int(f.read().rsplit(")", 1)[1].split()[36])
            out["cores"] = len(os.sched_getaffinity(0))
        except (OSError, IndexError, ValueError):
            pass
        return out

    def report(self, window_s: float) -> None:
        import sys

        a, b = self.a, self._read()
        steal = ((b["steal"] - a["steal"]) / max(b["ticks"] - a["ticks"], 1)
                 if "ticks" in a and "ticks" in b else float("nan"))
        print(f"host: load {a.get('load')} -> {b.get('load')}, steal {100 * steal:.2f}%, "
              f"process cpu {b['cpu_s'] - a['cpu_s']:.2f} s of {window_s:.2f} s, "
              f"involuntary switches {b['switches'] - a['switches']}, core {a.get('core')} -> "
              f"{b.get('core')} of {b.get('cores')}", file=sys.stderr, flush=True)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    """The allocator's peak on the card since ``reset_peak`` (0 elsewhere)."""
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
