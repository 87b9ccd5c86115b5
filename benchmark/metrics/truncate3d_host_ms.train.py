"""Host ms a traced training step inside the program's ``truncate3d`` spans on
the main thread (``fourier_truncate_3d``: the launches of each 3-D block's
Fourier truncation in the loss's forward)."""

from benchmark import spans


def read(r):
    return spans.host_ms(r, "truncate3d")
