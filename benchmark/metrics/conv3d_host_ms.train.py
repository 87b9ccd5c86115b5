"""Host ms a traced training step inside the program's ``conv3d`` spans on the
main thread (``spectral_conv_3d``: the launches of each 3-D block's spectral
conv in the loss's forward)."""

from benchmark import spans


def read(r):
    return spans.host_ms(r, "conv3d")
