"""Kernel K4 (``ops/cuda/gen_kernel_hbm.py``): its share of its roofline
in the window. The least time is the larger of the operations the useful
lane-steps need (samples delivered and prime classes ingested, never idle
lanes) at the f32 peak and the bytes of each launch's weights and of its
lanes' state read and written once; the share is that over K4's device
time in the window, by kernel name."""

from .. import roofline


def read(r):
    t = r.kernel_s("K4")
    if t <= 0:
        return None
    s0, s1 = r.x.get("stats0"), r.x.get("stats1")
    steps = r.x["samples_in_window"] + r.x["prime_steps"]
    chunks = s1["pool_steps"] - s0["pool_steps"] if s0 and s1 else 0
    lane_launches = chunks * r.x["lanes"] + r.x["admitted_in_window"]
    least, _ = roofline.gen_bound_s(r.model, steps, r.launches("K4"),
                                    lane_launches)
    return 100.0 * least / t
