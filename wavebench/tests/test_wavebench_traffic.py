"""The load generator: a seed fixes the schedule, lengths and primes; two
seeds offer the same set of work in another order; the offered rate is
the configured one."""

import numpy as np
import pytest

from wavebench import inputs, spec, traffic

MIXES = ["pool_saturated", "pool_open", "stream"]


def _mix(name):
    return spec._read(spec.BENCH_DIR / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = _mix(name)
    a = traffic.requests(mix, 2**31 + 5, 500, 3070, 1 << 20)
    b = traffic.requests(mix, 2**31 + 5, 500, 3070, 1 << 20)
    assert a == b


@pytest.mark.parametrize("name", MIXES)
def test_seeds_share_the_work(name):
    mix = _mix(name)
    n = int(mix.get("deck", 1))
    a = traffic.requests(mix, 1, n, 3070, 1 << 20)
    b = traffic.requests(mix, 2, n, 3070, 1 << 20)
    assert sorted(r.length for r in a) == sorted(r.length for r in b)
    if mix.get("loop") == "open":
        ga = np.diff([0.0] + [r.due for r in a])
        gb = np.diff([0.0] + [r.due for r in b])
        assert np.allclose(np.sort(ga), np.sort(gb))
    if n > 1:
        assert [r.length for r in a] != [r.length for r in b]
        assert [r.prime_off for r in a] != [r.prime_off for r in b] or \
            mix.get("prime", 1) == 1


def test_offered_rate_matches():
    mix = _mix("pool_open")
    n = 4 * int(mix["deck"])
    reqs = traffic.requests(mix, 3, n, 3070, 1 << 20)
    rate = n / reqs[-1].due
    assert rate == pytest.approx(mix["rate_per_s"], rel=0.01)


def test_lengths_are_log_uniform_quantiles():
    mix = _mix("pool_saturated")
    deck = traffic.length_deck(mix)
    assert deck.min() >= mix["length_min"] and deck.max() <= mix["length_max"]
    assert np.median(deck) == pytest.approx(16000, rel=0.01)


def test_primes_and_temperatures():
    mix = _mix("pool_open")
    sig = np.arange(1 << 16) % 256
    reqs = traffic.requests(mix, 9, 64, 3070, len(sig))
    for r in reqs:
        p = traffic.prime_of(r, sig, 256)
        assert len(p) == 3070 and np.array_equal(
            p, sig[r.prime_off:r.prime_off + 3070])
        temps = mix["temperatures"]
        assert r.temperature == temps[r.idx % len(temps)]
    unprimed = traffic.requests(_mix("pool_saturated"), 9, 4, 3070, len(sig))
    assert list(traffic.prime_of(unprimed[0], sig, 256)) == [128]


def test_inputs_repeat_from_the_seed():
    m = spec._read(spec.BENCH_DIR / "configs" / "chaconne.json")["model"]
    a = inputs.make_weights(m, 2**40 + 3, "cpu")
    b = inputs.make_weights(m, 2**40 + 3, "cpu")
    c = inputs.make_weights(m, 2**40 + 4, "cpu")
    assert all(bool((a[k][j] == b[k][j]).all()) for k in a for j in a[k])
    assert not bool((a["end2"]["w"] == c["end2"]["w"]).all())
    s1 = inputs.make_signal(11, 4096, 256, "cpu")
    assert bool((s1 == inputs.make_signal(11, 4096, 256, "cpu")).all())
    assert 0 <= int(s1.min()) and int(s1.max()) < 256
