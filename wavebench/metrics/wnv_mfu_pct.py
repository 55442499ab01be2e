"""Device, the whole step, for the WaveNet vocoder: the model's operations
for the samples the window delivered (``roofline_wnv.step_flops`` each),
over the window's length by the host's clock, as a share of the
configuration's peak."""

from .. import roofline_wnv


def read(r):
    window_s = r.x.get("window_s", 0.0)
    if window_s <= 0:
        return None
    flops = r.x["samples_in_window"] * roofline_wnv.step_flops(r.model)
    return 100.0 * flops / window_s / roofline_wnv.peak(r.model)
