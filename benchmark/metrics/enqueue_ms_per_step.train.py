"""Host ms a step to issue the window: the host clock around each window's
call, before its readback, summed over the window and divided by its
steps."""


def read(traced, window):
    if not window or not window.get("enqueue_ms"):
        return None
    return sum(window["enqueue_ms"]) / len(window["enqueue_ms"])
