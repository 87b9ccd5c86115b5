"""The fused projection head's share of its roofline, in %: the bound of
the head's forward and, in training, its backward (counts.head_bounds_s)
over the device time of the kernels named here."""

from benchmark import layers

PATTERNS = ("mlp_head_",)


def read(r):
    return layers.roofline(r, "head_s", PATTERNS)
