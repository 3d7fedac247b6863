"""The share (%) of the traced window's wall time in which no operation
ran on the device: 1 - the union of the device records' intervals over
the window."""

from harness.readers import idle_share


def read(traced, window):
    return idle_share(traced)
