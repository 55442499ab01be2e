"""The one load generator. A traffic mix is a JSON file of parameters
(``traffic/<name>.json``); this module turns it and ``--seed`` into the
requests, their order and their schedule.

Every seed gets the same set of request lengths and of gaps between
arrivals, in another order: lengths are the quantiles of the mix's
log-uniform distribution over one deck, gaps the quantiles of an
exponential distribution at the mix's rate (a Poisson process), each deck
shuffled by the seed. So two seeds offer the same work, and a run's
spread is the system's and not the draw's.

Keys of a mix (``kind`` picks the load: ``pool``, ``stream``):

- ``loop``: ``closed`` (``clients`` each send the next request when the
  last completes) or ``open`` (arrivals at ``rate_per_s``);
- ``length`` (fixed) or ``length_min``/``length_max`` (log-uniform), in
  samples to generate; ``deck``: the number of quantiles in a deck;
- ``prime``: classes given before generation: 1 is the unprimed request
  (one mid-class sample, the server's default), ``"rf"`` the model's
  receptive field, or a count; primes are cut from the run's signal;
- ``temperatures``: request i samples at ``temperatures[i % len]`` (0 is
  greedy);
- ``ramp_s``: seconds of traffic before the window opens.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .inputs import TRAFFIC, rng


@dataclass
class Request:
    idx: int
    length: int          # samples to generate
    prime_len: int
    prime_off: int       # where the prime starts in the signal (-1: unprimed)
    temperature: float
    seed: int            # the request's sampling seed
    due: float = 0.0     # open loop: seconds after the schedule starts


def prime_length(mix: dict, receptive_field: int) -> int:
    p = mix.get("prime", 1)
    return receptive_field if p == "rf" else int(p)


def length_deck(mix: dict) -> np.ndarray:
    """The deck's lengths in ascending order."""
    n = int(mix.get("deck", 1))
    if "length" in mix:
        return np.full(n, int(mix["length"]), np.int64)
    lo, hi = math.log(mix["length_min"]), math.log(mix["length_max"])
    q = (np.arange(n) + 0.5) / n
    return np.rint(np.exp(lo + q * (hi - lo))).astype(np.int64)


def gap_deck(mix: dict) -> np.ndarray:
    """The deck's gaps between arrivals (seconds), ascending."""
    n = int(mix.get("deck", 1))
    q = (np.arange(n) + 0.5) / n
    return -np.log1p(-q) / float(mix["rate_per_s"])


def _shuffled(deck: np.ndarray, r: np.random.Generator, count: int):
    out = []
    while sum(len(x) for x in out) < count:
        out.append(r.permutation(deck))
    return np.concatenate(out)[:count]


def requests(mix: dict, seed: int, count: int, receptive_field: int,
             signal_len: int, classes: int = 256) -> list[Request]:
    """The first ``count`` requests of the run (``due`` set for an open
    loop)."""
    r = rng(seed, TRAFFIC)
    lengths = _shuffled(length_deck(mix), r, count)
    dues = np.zeros(count)
    if mix.get("loop") == "open":
        dues = np.cumsum(_shuffled(gap_deck(mix), r, count))
    plen = prime_length(mix, receptive_field)
    offs = (r.integers(0, signal_len - plen, count) if plen > 1
            else np.full(count, -1))
    seeds = r.integers(0, 2**31 - 1, count)
    temps = [float(t) for t in mix.get("temperatures", [1.0])]
    return [Request(i, int(lengths[i]), plen, int(offs[i]),
                    temps[i % len(temps)], int(seeds[i]), float(dues[i]))
            for i in range(count)]


def prime_of(req: Request, signal_host: np.ndarray, classes: int
             ) -> np.ndarray:
    """The request's prime classes (int32)."""
    if req.prime_off < 0:
        return np.asarray([classes // 2], np.int32)
    return signal_host[req.prime_off:req.prime_off + req.prime_len].astype(
        np.int32)
