"""Host ms a traced served batch inside the program's ``forward`` span on the
main thread (``UNOModel.forward``)."""

from benchmark import spans


def read(r):
    return spans.host_ms(r, "forward")
