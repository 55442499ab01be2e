"""Device: the share of the traced window in which no device operation
of any name runs (the union of kernel, copy and set intervals, clipped to
the window)."""

from .. import tracing


def read(r):
    if r.window_s <= 0 or not tracing.device_events(r.events):
        return None
    return 100.0 * (1.0 - tracing.busy_s(r.events, r.lo, r.hi) / r.window_s)
