"""Lane pool: the 95th percentile of a request's wait from submit to
admission (``GenerationHandle.timing``: t_admitted - t_submit), over the
requests due in the window. Moves ``ttfa_p95_ms``."""

from . import p95_ms


def read(r):
    return p95_ms(r.x.get("admit_waits") or [])
