"""Host ms a traced training step inside the program's ``forward`` spans on the
main thread (``UNOModel.forward``: the launches of the loss's forward)."""

from benchmark import spans


def read(r):
    return spans.host_ms(r, "forward")
