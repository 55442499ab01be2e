"""Device, the whole step: the model's operations for the work the window
delivered, over the window's length by the host's clock, as a share of
the configuration's peak: the operations of a generated sample x samples
delivered."""

from .. import roofline


def read(r):
    window_s = r.x.get("window_s", 0.0)
    if window_s <= 0:
        return None
    flops = r.x["samples_in_window"] * roofline.step_flops(r.model)
    return 100.0 * flops / window_s / roofline.peak(r.model)
