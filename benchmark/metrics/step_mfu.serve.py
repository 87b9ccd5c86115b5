"""The served batches' flops (counts.step_flops) over their wall time, in % of
the chip's bf16 peak."""

from benchmark import layers


def read(r):
    return layers.mfu(r)
