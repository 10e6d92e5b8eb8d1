"""The device's idle share of a traced training window, in %: 1 − the
union of its kernels' intervals over the window (`lib/trace.py`)."""


def read(m):
    if m.kind != "train" or m.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - m.trace.busy_s / m.trace.window_s)
