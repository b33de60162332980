"""The device's idle share in training: 1 - (the union of the device's
busy intervals in the traced window) / the window's length."""
from benchmark.harness import readers


def read(run):
    return readers.idle(run)
