"""cuFFT's inverse real FFT against numpy's on half spectra whose DC and
Nyquist slices are not Hermitian, as a U-NO's output spectrum is not, and
the spectral conv of uno_s256's last block on the card against the CPU.

    python3 tools/torch_c2r_check.py        # one CUDA card

For each size n in (64, 128, 256, 512) it prints the rel-L2 of
``torch.fft.irfft2`` of a random (2, 32, n, n // 2 + 1) complex64 half
spectrum on the card against numpy's float64 ``irfft2`` of the same
spectrum (pocketfft, which keeps the Hermitian part of those slices, as
torch's CPU c2r and ``uno_tpu``'s do), raw and after the port's
``_hermitian_c2r`` (``uno_tpu_torch/ops/spectral.py``).  Then uno_s256's
last block at width 32 (128 channels at 64x64 -> 32 at 256x256, modes
(32, 32)): its spectral conv on the card against the CPU, f32, on the same
input and weights.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from uno_tpu_torch.ops.spectral import (  # noqa: E402
    _hermitian_c2r,
    spectral_conv_2d,
    spectral_weight_init,
)


def _rel(a, b) -> float:
    a = torch.as_tensor(a).detach().cpu().double()
    b = torch.as_tensor(b).detach().cpu().double()
    return float((a - b).norm() / b.norm())


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_c2r_check: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    rng = np.random.default_rng(0)
    for n in (64, 128, 256, 512):
        shape = (2, 32, n, n // 2 + 1)
        spec = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
        want = np.fft.irfft2(spec.astype(np.complex128), s=(n, n))
        raw = torch.fft.irfft2(torch.from_numpy(spec).to(dev), s=(n, n))
        fixed = torch.fft.irfft2(_hermitian_c2r(torch.from_numpy(spec).to(dev), n, (-1,)),
                                 s=(n, n))
        print(f"[c2r] irfft2 {n}x{n} on the card against numpy: raw rel-L2 {_rel(raw, want):.3g}, "
              f"after _hermitian_c2r {_rel(fixed, want):.3g}")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 128, 64, 64, generator=g)
    w = spectral_weight_init(128, 32, (32, 32), 2, g, "cpu")
    with torch.no_grad():
        cpu = spectral_conv_2d(x, w, (256, 256), (32, 32))
        card = spectral_conv_2d(x.to(dev), w.to(dev), (256, 256), (32, 32))
    print(f"[c2r] uno_s256's last spectral conv (128 x 64x64 -> 32 x 256x256, modes 32) card "
          f"against CPU: rel-L2 {_rel(card, cpu):.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
