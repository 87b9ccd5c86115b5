"""The 3-D transforms' share of their roofline, in %: the bound of the
configuration's r2c and c2r transforms, forward and backward
(``uno3d_counts.transforms``, under ``fft_s``), over the device time of the
kernels that ``fft_ms`` counts, whatever implements the transforms."""

from benchmark import layers

PATTERNS = ("fft",)


def read(r):
    return layers.roofline(r, "fft_s", PATTERNS)
