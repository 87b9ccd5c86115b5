"""Ms a traced served batch with nothing on the device while the host's main
thread was inside none of the program's spans: in the caller."""

from benchmark import spans


def read(r):
    split = spans.idle_split(r)
    return None if split is None else split[1]
