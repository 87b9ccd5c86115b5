"""Kernels, copies and sets on the device a training step."""

from benchmark import layers


def read(r):
    return layers.activities(r)
