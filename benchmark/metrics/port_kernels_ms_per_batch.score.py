"""Device ms a batch of the port's own kernels (ops/ over csrc/), by
their names."""

from harness.readers import is_port, ms_per_unit


def read(traced, window):
    return ms_per_unit(traced, is_port)
