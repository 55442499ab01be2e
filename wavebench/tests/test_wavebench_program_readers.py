"""The readers of the program's own spans and counters, on synthetic
traces and ``stats()``: ``k1_prep_idle_pct`` and ``prime_device_pct``."""

import pytest

from wavebench import metrics
from wavebench.metrics import idle_pct, k1_prep_idle_pct, prime_device_pct


def _kernel(ts, dur):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": dur}


def _span(ts, dur, name="k1.prepare", tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "tid": tid}


def _reading(events=(), x=None, lo=0.0, hi=1000.0):
    return metrics.Reading({}, {}, x or {}, list(events), lo, hi)


def test_prep_idle_counts_only_idle_time_inside_the_span():
    # window 0-1000 µs; the card runs 0-100 and 300-900; k1.prepare spans
    # 50-400: idle inside it is 100-300 (200 µs); the idle 900-1000 lies
    # outside every span, and a k1.launch span over it is not counted
    events = [_kernel(0, 100), _kernel(300, 600), _span(50, 350),
              _span(900, 100, name="k1.launch"),
              {"ph": "X", "cat": "gpu_user_annotation", "name": "k1.prepare",
               "ts": 900, "dur": 100}]
    r = _reading(events)
    assert k1_prep_idle_pct.read(r) == pytest.approx(20.0)
    assert idle_pct.read(r) == pytest.approx(30.0)


def test_prep_idle_counts_overlapping_spans_once_and_clips_to_the_window():
    # two threads' spans overlap over 100-250 and 200-300, one more runs
    # past the window's end: idle inside them 100-300 and 900-1000
    events = [_kernel(0, 100), _kernel(300, 600), _span(100, 150),
              _span(200, 100, tid=2), _span(850, 400)]
    r = _reading(events)
    assert k1_prep_idle_pct.read(r) == pytest.approx(30.0)
    assert k1_prep_idle_pct.read(r) <= idle_pct.read(r)


def test_prep_idle_is_none_without_device_events_or_spans():
    assert k1_prep_idle_pct.read(_reading([_span(0, 500)])) is None
    assert k1_prep_idle_pct.read(_reading([_kernel(0, 10)])) is None
    # a span that never overlaps idle time reads 0, not None
    assert k1_prep_idle_pct.read(
        _reading([_kernel(0, 1000), _span(10, 20)])) == 0.0


def test_prime_device_pct_reads_the_stats_deltas():
    s0 = {"t_prime_device": 1.5, "t_chunk_device": 2.0, "pool_steps": 3}
    s1 = {"t_prime_device": 16.7, "t_chunk_device": 16.79, "pool_steps": 59}
    r = _reading(x={"stats0": s0, "stats1": s1})
    assert prime_device_pct.read(r) == pytest.approx(
        100 * 15.2 / (15.2 + 14.79))


def test_prime_device_pct_is_none_when_nothing_moved_or_nothing_counts():
    s = {"t_prime_device": 2.0, "t_chunk_device": 3.0}
    assert prime_device_pct.read(_reading(x={"stats0": s,
                                             "stats1": dict(s)})) is None
    old = {"pool_steps": 3, "t_prime_sync": 0.5}  # a program without them
    assert prime_device_pct.read(_reading(x={"stats0": old,
                                             "stats1": old})) is None
    assert prime_device_pct.read(_reading(x={})) is None
