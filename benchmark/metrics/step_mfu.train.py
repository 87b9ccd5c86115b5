"""The training steps' flops (counts.step_flops) over their wall time, in % of
the chips' bf16 peak."""

from benchmark import layers


def read(r):
    return layers.mfu(r)
