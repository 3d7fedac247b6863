"""The whole batch's share (%) of the card's peak for the configuration's
dtype: the operations the work needs, counted from the configuration's
shapes (harness/yardstick.py), over the untraced window's time."""

from harness.readers import mfu


def read(traced, window):
    return mfu(window)
