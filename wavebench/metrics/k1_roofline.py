"""Kernel K1 (``ops/cuda/gen_kernel.py``): its share of its roofline in
the window: the useful steps (samples yielded and prime classes ingested)
at the f32 peak, or one stream's weights and state read and written once
a launch, whichever bounds, over K1's device time by kernel name."""

from .. import roofline


def read(r):
    t = r.kernel_s("K1")
    if t <= 0:
        return None
    steps = r.x["samples_in_window"] + r.x["prime_steps"]
    n = r.launches("K1")
    least, _ = roofline.gen_bound_s(r.model, steps, n, n)
    return 100.0 * least / t
