"""Kernel KW (``ops/cuda/gen_kernel_wide.py``, the wide-chain step): its
share of its roofline in the window. The least time is the larger of the
operations of the useful lane-steps (samples delivered and prime classes
ingested, never idle lanes) at the f32 peak and the bytes of the weights
read once a kernel step plus each useful lane-step's tap and ring rows
(``roofline_wnv.py``); the share is that over KW's device time in the
window, found by its kernel's name."""

import re

from .. import roofline_wnv, tracing

KERNEL = re.compile(r"wide_step_kernel")


def read(r):
    events = [e for e in r.events if e.get("cat") == "kernel"
              and KERNEL.search(e.get("name", ""))]
    t = tracing.clipped_s(events, r.lo, r.hi)
    s0, s1 = r.x.get("stats0"), r.x.get("stats1")
    if t <= 0 or not s0 or not s1:
        return None
    lane_steps = r.x["samples_in_window"] + r.x["prime_steps"]
    # each pool chunk runs `chunk` steps, each prime call of unprimed
    # requests one (a primed call's ingested classes count once more a
    # request: an upper count where a call primes several)
    steps = ((s1["pool_steps"] - s0["pool_steps"]) * r.x["chunk"]
             + s1["prime_calls"] - s0["prime_calls"] + r.x["prime_steps"])
    least, _ = roofline_wnv.bound_s(r.model, lane_steps, steps)
    return 100.0 * least / t
