"""Host ms a traced training step inside the program's ``backward`` span on the
main thread (the ``.backward()`` call: it returns when the autograd engine has
launched the whole backward)."""

from benchmark import spans


def read(r):
    return spans.host_ms(r, "backward")
