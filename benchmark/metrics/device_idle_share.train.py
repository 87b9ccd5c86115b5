"""Share of the traced training steps' wall time with nothing on the device, in %."""

from benchmark import layers


def read(r):
    return layers.idle_share(r)
