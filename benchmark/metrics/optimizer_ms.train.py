"""ms a step of the optimizer's step: CUDA events on the stream around the
benchmark's call of ``opt.step()``, averaged over the traced steps."""

from benchmark import layers


def read(r):
    return layers.span_ms(r, "optimizer")
