"""Device ms a step of every other PyTorch kernel: elementwise, copies,
reductions, Adam's foreach (neither a library kernel nor the port's)."""

from harness.readers import is_eager, ms_per_unit


def read(traced, window):
    return ms_per_unit(traced, is_eager)
