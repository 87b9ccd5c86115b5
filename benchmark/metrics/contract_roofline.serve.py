"""The spectral contraction's share of its roofline, in %: the bound of the
configuration's contractions (counts.contract_bound_s, each block's forward
and, in training, both gradients) over the device time of the kernels named
here."""

from benchmark import layers

PATTERNS = ("contract_kernel",)


def read(r):
    return layers.roofline(r, "contract_s", PATTERNS)
