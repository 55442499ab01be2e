"""Per-layer metrics: one small reader a file. The harness loads
``metrics/<name>.py``, or, for a name ``<base>.<cell-kind>`` with no file
of its own, ``metrics/<base>.py``, and calls its ``read(r)`` with a
:class:`Reading` of the traced run. A reader that finds nothing to read
returns None, and the metric is left out of the result line."""

from __future__ import annotations

from dataclasses import dataclass

from .. import tracing


@dataclass
class Reading:
    model: dict     # the configuration's model fields
    mix: dict       # the traffic mix
    x: dict         # what the load recorded for readers
    events: list    # the trace's complete events
    lo: float       # the traced window in the trace's clock (µs)
    hi: float

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def kernel_s(self, kernel: str) -> float:
        return tracing.clipped_s(tracing.kernel_events(self.events, kernel),
                                 self.lo, self.hi)

    def launches(self, kernel: str) -> int:
        return sum(1 for e in tracing.kernel_events(self.events, kernel)
                   if float(e["ts"]) < self.hi
                   and float(e["ts"]) + float(e.get("dur", 0)) > self.lo)


def p95_ms(values) -> float | None:
    from ..loads import nearest_rank

    return 1e3 * nearest_rank(list(values), 0.95) if values else None
