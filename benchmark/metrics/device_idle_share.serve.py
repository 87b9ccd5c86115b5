"""Share of the traced served batches' wall time with nothing on the device, in %."""

from benchmark import layers


def read(r):
    return layers.idle_share(r)
