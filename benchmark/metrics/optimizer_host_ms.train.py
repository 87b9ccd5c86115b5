"""Host ms a traced training step inside the program's ``optimizer`` span on
the main thread (``ComplexAdam.step``)."""

from benchmark import spans


def read(r):
    return spans.host_ms(r, "optimizer")
