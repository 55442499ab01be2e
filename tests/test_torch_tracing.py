"""The port's own profiler spans and counters, on the CPU: the single
stream's ``synth.*`` and ``k1.*`` spans, the lane pool's ``pool.*``
phases (one helper feeds both the spans and ``stats()``'s host seconds)
and its device-clock counters, which stay 0.0 without a card.

This file imports neither JAX nor the JAX package."""

import json
import time
from collections import deque

import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu_torch.serving import ContinuousBatcher
from pytorch_wavenet_tpu_torch.serving.server import Synthesizer
from pytorch_wavenet_tpu_torch.utils import profiling

K1_SPANS = ("k1.prepare", "k1.launch", "k1.finish")
POOL_PHASES = ("admit", "prime_dispatch", "splice", "dispatch", "prime_sync",
               "deliver", "idle")
DEVICE_KEYS = ("t_prime_device", "t_chunk_device")


@pytest.fixture(scope="module")
def tiny():
    cfg = pt.get_config("tiny")
    return cfg, pt.init_wavenet(cfg, torch.Generator().manual_seed(0), "cpu")


def _spans(path, names) -> list:
    """The host spans among ``names`` in a trace written by
    ``profiling.trace``, by start time."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and e.get("name") in names),
                  key=lambda e: float(e["ts"]))


def _inside(e, outer) -> bool:
    lo, hi = float(outer["ts"]), float(outer["ts"]) + float(outer["dur"])
    return lo <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= hi


def test_stream_chunk_spans(tiny, tmp_path):
    """Each chunk of ``Synthesizer.stream`` is one ``synth.chunk`` span
    holding ``k1.prepare``, ``k1.launch`` and ``k1.finish`` in that order,
    then ``synth.copy``."""
    cfg, params = tiny
    synth = Synthesizer(params, cfg, device="cpu")
    prime = np.arange(cfg.receptive_field) % cfg.classes
    with profiling.trace(str(tmp_path)) as path:
        parts = list(synth.stream(40, 1.0, 3, 16, prime=prime))
    assert [len(p) for p in parts] == [16, 16, 8]
    names = ("synth.chunk", "synth.copy") + K1_SPANS
    spans = _spans(path, names)
    chunks = [e for e in spans if e["name"] == "synth.chunk"]
    assert len(chunks) == 3
    for chunk in chunks:
        inner = [e for e in spans if e is not chunk and _inside(e, chunk)]
        assert [e["name"] for e in inner] == [*K1_SPANS, "synth.copy"]
        for a, b in zip(inner, inner[1:]):  # one after another
            assert float(a["ts"]) + float(a["dur"]) <= float(b["ts"])
    assert not [e for e in spans if e["name"] != "synth.chunk"
                and not any(_inside(e, c) for c in chunks)]


def test_fused_call_spans_outside_the_stream(tiny, tmp_path):
    """``generate_fast_fused`` alone emits its three spans once a call,
    with and without a returned state."""
    cfg, params = tiny
    with profiling.trace(str(tmp_path)) as path:
        _, _, state = pt.generate_fast_fused(
            params, cfg, 1, 8, return_state=True, device="cpu")
        pt.generate_fast_fused(params, cfg, 1, 8, state=state, device="cpu")
    assert [e["name"] for e in _spans(path, K1_SPANS)] == [*K1_SPANS] * 2


def _pool_run(params, cfg, tmp_path):
    """A CPU pool serving three requests (two prime lengths, so at least
    two prime calls) inside a trace; returns the trace's path, the
    pool's ``_t`` before and after and ``stats()`` after."""
    pool = ContinuousBatcher(params, cfg, lanes=2, chunk=8, device="cpu")
    try:
        pool.prewarm()
        t0 = dict(pool._t)
        rng = np.random.default_rng(0)
        with profiling.trace(str(tmp_path)) as path:
            hs = [pool.submit(rng.integers(0, cfg.classes, n), 20, seed=i)
                  for i, n in enumerate((cfg.receptive_field, 5, 5))]
            for h in hs:
                h.result(timeout=60)
            time.sleep(0.3)  # the worker idles at least once
        t1, stats = dict(pool._t), pool.stats()
    finally:
        pool.close()
    return path, t0, t1, stats


def test_pool_phases_are_spans_and_timers(tiny, tmp_path):
    """Every ``pool.<phase>`` span appears, on the worker's thread alone,
    and each phase's ``t_<phase>`` grew: one helper feeds both."""
    cfg, params = tiny
    path, t0, t1, stats = _pool_run(params, cfg, tmp_path)
    spans = _spans(path, {"pool." + p for p in POOL_PHASES})
    assert {e["name"] for e in spans} == {"pool." + p for p in POOL_PHASES}
    capture = _spans(path, {profiling.CAPTURE_SPAN})
    assert len({e["tid"] for e in spans}) == 1
    assert spans[0]["tid"] != capture[0]["tid"]  # the worker's, not ours
    for p in POOL_PHASES:
        assert t1["t_" + p] > t0["t_" + p], p
        assert stats["t_" + p] == round(t1["t_" + p], 3)
    assert stats["completed"] == 3 and stats["prime_calls"] >= 2


def test_device_counters_are_zero_on_the_cpu(tiny, tmp_path):
    """``t_prime_device`` and ``t_chunk_device`` are in ``stats()`` and
    stay 0.0 where there is no card to time."""
    cfg, params = tiny
    _, _, t1, stats = _pool_run(params, cfg, tmp_path)
    for key in DEVICE_KEYS:
        assert stats[key] == 0.0 and t1[key] == 0.0
    assert stats["pool_steps"] > 0


class _Event:
    def __init__(self, ms=0.0, done=True):
        self.ms, self.done = ms, done

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert end.done
        return end.ms - self.ms


def test_card_pairs_are_read_oldest_first_once_done():
    """``_read_card`` adds each finished launch's event time (ms) to its
    key in seconds, oldest first, and stops at the first pair not done;
    ``_phase`` adds its host seconds even when the phase raises."""
    b = ContinuousBatcher.__new__(ContinuousBatcher)  # no worker thread
    b._t = {k: 0.0 for k in DEVICE_KEYS + ("t_admit",)}
    b._card = deque([
        ("t_prime_device", _Event(1.0), _Event(251.0)),
        ("t_chunk_device", _Event(251.0), _Event(515.0)),
        ("t_chunk_device", _Event(515.0), _Event(779.0, done=False)),
        ("t_prime_device", _Event(779.0), _Event(800.0))])
    b._read_card()
    assert b._t["t_prime_device"] == pytest.approx(0.25)
    assert b._t["t_chunk_device"] == pytest.approx(0.264)
    assert len(b._card) == 2
    b._card[0][2].done = True
    b._read_card()
    assert b._t["t_prime_device"] == pytest.approx(0.271)
    assert b._t["t_chunk_device"] == pytest.approx(0.528)
    assert not b._card
    with pytest.raises(RuntimeError, match="boom"):
        with b._phase("t_admit"):
            time.sleep(0.01)
            raise RuntimeError("boom")
    assert b._t["t_admit"] >= 0.01
