"""Lane pool: the prime calls' share of K4's time on the card in the
window, from ``ContinuousBatcher.stats()`` at its edges: the change in
``t_prime_device`` over the change in ``t_prime_device +
t_chunk_device`` (both on the card's clock), x 100. None where the
program has no such counters or they did not move. Moves
``ttfa_p95_ms``."""


def read(r):
    s0, s1 = r.x.get("stats0"), r.x.get("stats1")
    keys = ("t_prime_device", "t_chunk_device")
    if not s0 or not s1 or any(k not in s0 or k not in s1 for k in keys):
        return None
    prime, chunk = (s1[k] - s0[k] for k in keys)
    if prime + chunk <= 0:
        return None
    return 100.0 * prime / (prime + chunk)
