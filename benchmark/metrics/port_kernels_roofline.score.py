"""The port kernels' share of their roofline (%): the sum of each
launch's least time (the larger of its operations at the peak for its
dtype and its bytes at 3.35 TB/s, from the shapes the benchmark's spans
recorded: harness/port_calls.py) over the sum of their device time."""

from harness.readers import port_roofline


def read(traced, window):
    return port_roofline(traced)
