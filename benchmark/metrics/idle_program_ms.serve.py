"""Ms a traced served batch with nothing on the device while the host's main
thread was inside one of the program's top spans (``forward``)."""

from benchmark import spans


def read(r):
    split = spans.idle_split(r)
    return None if split is None else split[0]
