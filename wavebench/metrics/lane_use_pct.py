"""Lane pool: the share of the pool's lane-steps in the window that
delivered a sample, from ``ContinuousBatcher.stats()`` at its edges:
samples out / (pool steps x chunk x lanes). Moves ``samples_per_s``."""


def read(r):
    s0, s1 = r.x.get("stats0"), r.x.get("stats1")
    if not s0 or not s1:
        return None
    steps = s1["pool_steps"] - s0["pool_steps"]
    if steps <= 0:
        return None
    out = s1["samples_out"] - s0["samples_out"]
    return 100.0 * out / (steps * r.x["chunk"] * r.x["lanes"])
