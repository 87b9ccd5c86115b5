"""Build and load the port's CUDA kernels.

The sources under ``uno_tpu_torch/csrc/*.cu`` expose plain ``extern "C"``
entry points that launch on a given stream and return ``cudaGetLastError()``.
At first use they are compiled with ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` process per source, all started together, and linked into one
shared library under ``build/uno_tpu_torch/`` at the repository root, named
by a hash of the sources and flags, and loaded with ``ctypes``.  Nothing is
built when a module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "uno_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argtypes (pointers and the stream as c_void_p, ints as c_int)
_SIGNATURES = {
    # B, Ci, Co, M, then the launch plan (cmul.py: ContractPlan.args)
    "uno_cmul_fwd": [_P, _P, _P] + [_I] * 11 + [_P],
    "uno_cmul_bwd_x": [_P, _P, _P] + [_I] * 11 + [_P],
    "uno_cmul_bwd_w": [_P, _P, _P] + [_I] * 11 + [_P],
    # B, C, N, H, O, then the launch plan (mlp_head.py: FwdPlan.args, BwdPlan.args)
    "uno_mlp_head_fwd": [_P] * 6 + [_I] * 10 + [_P],
    "uno_mlp_head_bwd": [_P] * 11 + [_I] * 11 + [_P],
    # the step's table in host memory, its entries, the grid (adam.py: Launch)
    "uno_adam_step": [_P, _I, _I, _P],
    # src, dst, the table and scales on the card, B*C, S1..S3, D1..D3, threads
    # a block, channel slices (remap.py)
    "uno_remap": [_P] * 4 + [_I] * 9 + [_P],
    # device, then where to write its SM count and opt-in shared memory
    "uno_device_limits": [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)],
}

# an H100's SM count and opt-in shared memory per block (227 KB): the launch
# plans' limits when no device is named; a launch reads its own card's
SMS, MAX_SMEM = 132, 232448

_LIB = None
BUILD_LOG = ""        # nvcc's output (ptxas register / shared-memory report)
BUILD_SECONDS = None  # wall time of the compile; 0.0 when the library existed


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels cannot be built"
        )
    return found


def library() -> ctypes.CDLL:
    """The compiled kernel library, built on first call."""
    global _LIB, BUILD_LOG, BUILD_SECONDS
    if _LIB is not None:
        return _LIB
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD_DIR / f"libuno_kernels_{h.hexdigest()[:16]}.so"
    BUILD_SECONDS = 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            nvcc = _nvcc()
            objs = [str(Path(tmp) / f"{s.stem}.o") for s in sources]
            procs = [
                (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True))
                for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", o, str(s)]
                            for o, s in zip(objs, sources))
            ]
            logs = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
            link = [nvcc, "-shared", "-o", str(Path(tmp) / "lib.so"), *objs]
            if all(rc == 0 for _, _, rc in logs):
                proc = subprocess.run(link, capture_output=True, text=True)
                logs.append((link, proc.stdout + proc.stderr, proc.returncode))
            BUILD_LOG = "".join(log for _, log, _ in logs)
            for cmd, log, rc in logs:
                if rc != 0:
                    raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{log}")
            # atomic: a concurrent loader never sees half a file
            os.replace(Path(tmp) / "lib.so", out)
        BUILD_SECONDS = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.uno_error_string.argtypes = [_I]
    lib.uno_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = library().uno_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} (cudaError_t {err})")


@functools.lru_cache(maxsize=None)
def device_limits(index: int) -> tuple:
    """(SM count, shared-memory bytes a block may opt in to) of CUDA device
    ``index``, as the runtime reports them."""
    sms, smem = ctypes.c_int(), ctypes.c_int()
    check(library().uno_device_limits(index, ctypes.byref(sms), ctypes.byref(smem)),
          "uno_device_limits")
    return sms.value, smem.value
