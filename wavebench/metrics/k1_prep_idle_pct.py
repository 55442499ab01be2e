"""Single-stream path: the share of the traced window in which the card
runs nothing while the host is inside a ``k1.prepare`` span (the
operands ``generate_fast_fused`` builds before each K1 launch; the union
of those spans on any thread), x 100. Never above ``idle_pct``. None
where the trace holds no device event or no such span (a program
without the span). Moves ``stream_samples_per_s``."""

from .. import tracing

SPAN = "k1.prepare"


def read(r):
    if r.window_s <= 0 or not tracing.device_events(r.events):
        return None
    spans = [e for e in r.events if e.get("name") == SPAN
             and e.get("cat") == "user_annotation"]
    if not spans:
        return None
    busy = tracing.busy_intervals(r.events, r.lo, r.hi)
    idle_us = 0.0
    for a, b in _union(spans, r.lo, r.hi):
        idle_us += (b - a) - sum(max(0.0, min(b, d) - max(a, c))
                                 for c, d in busy)
    return 100.0 * idle_us / 1e6 / r.window_s


def _union(events, lo, hi):
    """The union of ``events``' intervals inside [lo, hi] (µs), sorted."""
    out = []
    for a, b in sorted((max(lo, float(e["ts"])),
                        min(hi, float(e["ts"]) + float(e.get("dur", 0))))
                       for e in events):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out
