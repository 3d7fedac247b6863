"""Kernel launches a batch (through the CUDA runtime or driver API), from
the traced window's host records."""

from harness.readers import launches_per_unit


def read(traced, window):
    return launches_per_unit(traced)
