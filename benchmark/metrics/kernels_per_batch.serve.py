"""Kernels, copies and sets on the device a served batch."""

from benchmark import layers


def read(r):
    return layers.activities(r)
