"""Continuous batching in the port (serving/batcher.py) on the CPU, where
the pool runs the plain version of the batched kernel K4.

The exactness contract: a pooled request is bitwise identical to a solo
``generate_fast_batched`` call with ``lane_seed=[seed]`` at the same
(prime, temperature), at every temperature, whenever it is admitted; and
that solo call equals the JAX package's in interpret mode."""

import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu.ops.pallas.gen_kernel_hbm import (
    generate_fast_batched as jax_batched,
)
from pytorch_wavenet_tpu_torch.serving import batcher as bm
from pytorch_wavenet_tpu_torch.serving import (
    ContinuousBatcher,
    PoolOverloaded,
    RequestCancelled,
)


def _np_params(cfg, seed):
    shapes = jax.eval_shape(lambda: wt.init_wavenet(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.uniform(-0.3, 0.3, s.shape).astype(np.float32), shapes)


@pytest.fixture(scope="module")
def tiny():
    cfgj = wt.get_config("tiny", kernel_size=3)
    cfg = pt.get_config("tiny", kernel_size=3)
    npp = _np_params(cfgj, 0)
    return cfg, pt.from_jax_params(npp, "cpu"), cfgj, npp


def _prime(cfg, seed, length=None):
    return np.random.default_rng(seed).integers(
        0, cfg.classes, length or cfg.receptive_field)


def _solo(params, cfg, prime, n, temperature=0.0, seed=0, **kw):
    _, cls = pt.generate_fast_batched(
        params, cfg, 0, n, np.asarray(prime)[None], temperature=temperature,
        lane_seed=[seed], device="cpu", **kw)
    return cls[0].numpy()


def _wait_for(handle, k, timeout=60.0):
    deadline = time.time() + timeout
    while sum(p.size for p in handle._parts) < k:
        if handle.done() or time.time() > deadline:
            break
        time.sleep(0.01)


def _pool(params, cfg, **kw):
    return ContinuousBatcher(params, cfg, device="cpu", **kw)


# (prime seed, prime length or None = receptive field, num_samples,
#  temperature, request seed, samples of the previous request to wait for)
SCENARIOS = {
    "staggered": dict(lanes=3, chunk=6, reqs=[
        (1, None, 25, 0.0, 0, 0), (2, None, 18, 0.0, 0, 7),
        (3, None, 11, 0.0, 0, 1)]),
    "burst": dict(lanes=4, chunk=7, reqs=[
        (4, None, 13, 0.0, 0, 0), (5, None, 13, 0.9, 8, 0),
        (6, None, 13, 1.0, 9, 0)]),
    "lane_reuse_mixed_temperature": dict(lanes=2, chunk=5, reqs=[
        (7, None, 15, 0.0, 0, 0), (7, None, 15, 1.2, 3, 0),
        (7, None, 8, 0.0, 0, 0), (8, 3, 9, 0.7, 4, 0)]),
    "fused_serving_flags_hot": dict(lanes=3, chunk=6, fuse_res=True,
                                    skip_slab=True, reqs=[
        (9, None, 20, 0.9, 11, 0), (10, 1, 14, 1.0, 12, 5),
        (11, 4, 9, 0.0, 0, 2)]),
    "light_chunk": dict(lanes=4, chunk=12, light_chunk=3,
                        light_threshold=0.5, reqs=[
        (12, None, 40, 0.0, 0, 0), (13, None, 25, 0.8, 2, 4),
        (14, None, 25, 0.0, 0, 0), (15, None, 25, 1.0, 5, 0)]),
    "regularize": dict(lanes=2, chunk=6, regularize=0.1, reqs=[
        (16, None, 18, 0.0, 0, 0), (17, 2, 12, 0.9, 6, 3)]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pooled_requests_equal_solo(tiny, name):
    """Requests admitted at different pool times, in bursts, onto recycled
    lanes and under chunk-width changes each equal their solo rollout."""
    cfg, params, _, _ = tiny
    spec = dict(SCENARIOS[name])
    reqs = spec.pop("reqs")
    flags = {k: spec[k] for k in ("fuse_res", "skip_slab", "regularize")
             if k in spec}
    b = _pool(params, cfg, **spec)
    try:
        handles = []
        for ps, length, n, temp, seed, wait in reqs:
            if handles and wait:
                _wait_for(handles[-1][0], wait)
            prime = _prime(cfg, ps, length)
            handles.append((b.submit(prime, n, temperature=temp, seed=seed),
                            prime, n, temp, seed))
        for h, prime, n, temp, seed in handles:
            wav, cls = h.result(timeout=120)
            assert wav.shape == (n,) and wav.dtype == np.float32
            np.testing.assert_array_equal(
                cls, _solo(params, cfg, prime, n, temp, seed, **flags))
    finally:
        b.close()
    if spec.get("light_chunk"):
        assert b.stats()["light_chunk"] == spec["light_chunk"]


def test_hot_requests_reproducible_and_equal_jax_solo(tiny):
    """A seeded hot request equals the JAX package's solo call with the same
    lane_seed, admitted mid-flight into a busy pool, and again when
    resubmitted later."""
    cfg, params, cfgj, npp = tiny
    prime = _prime(cfg, 20)
    n = 21
    _, solo = jax_batched(
        jax.tree.map(jnp.asarray, npp), cfgj, jax.random.PRNGKey(0), n,
        jnp.asarray(prime, jnp.int32)[None], temperature=jnp.asarray([0.9]),
        lane_seed=jnp.asarray([1234]), interpret=True)
    solo = np.asarray(solo)[0]
    assert len(set(solo.tolist())) > 1  # sampling, not greedy
    b = _pool(params, cfg, lanes=3, chunk=6)
    try:
        noise = b.submit(prime, 40, temperature=1.3)  # pool traffic
        _wait_for(noise, 7)
        _, cls = b.submit(prime, n, temperature=0.9,
                          seed=1234).result(timeout=120)
        np.testing.assert_array_equal(cls, solo)
        _, cls2 = b.submit(prime, n, temperature=0.9,
                           seed=1234).result(timeout=120)
        np.testing.assert_array_equal(cls2, solo)
        noise.result(timeout=120)
    finally:
        b.close()


def test_cancel_frees_the_lane(tiny):
    cfg, params, _, _ = tiny
    prime = np.asarray([cfg.classes // 2])
    b = _pool(params, cfg, lanes=1, chunk=4)
    try:
        doomed = b.submit(prime, 10_000, temperature=0.0)
        _wait_for(doomed, 5)
        doomed.cancel()
        # the single lane must free up for this one to ever complete
        _, cls = b.submit(prime, 8, temperature=0.0).result(timeout=120)
        np.testing.assert_array_equal(cls, _solo(params, cfg, prime, 8))
        assert doomed.done() and doomed.cancelled()
        with pytest.raises(RequestCancelled):
            doomed.result(timeout=0)
        # cancelled before admission: resolves, the pool still serves
        h = b.submit(prime, 1, temperature=0.0)
        h.cancel()
        with pytest.raises(RequestCancelled):
            h.result(timeout=120)
        assert b.submit(prime, 4).result(timeout=120)[1].shape == (4,)
    finally:
        b.close()


def test_raising_on_chunk_fails_only_that_request(tiny):
    cfg, params, _, _ = tiny
    prime = np.asarray([cfg.classes // 2])
    b = _pool(params, cfg, lanes=2, chunk=4)
    try:
        def boom(_):
            raise ValueError("consumer exploded")

        bad = b.submit(prime, 12, temperature=0.0, on_chunk=boom)
        good = b.submit(prime, 12, temperature=0.0)
        with pytest.raises(ValueError, match="consumer exploded"):
            bad.result(timeout=120)
        np.testing.assert_array_equal(good.result(timeout=120)[1],
                                      _solo(params, cfg, prime, 12))
        _, cls2 = b.submit(prime, 6, temperature=0.0).result(timeout=120)
        np.testing.assert_array_equal(cls2, _solo(params, cfg, prime, 6))
    finally:
        b.close()


def test_device_step_failure_fails_riders_and_pool_recovers(tiny,
                                                            monkeypatch):
    """A failed kernel call mid-rollout fails the riding handles (instead of
    hanging them) and the pool re-bootstraps for new work."""
    cfg, params, _, _ = tiny
    prime = np.asarray([cfg.classes // 2])
    real = bm.run_batched
    state = {"fail": False, "failed": False}

    def flaky(*args, **kwargs):
        if state["fail"]:
            state["fail"] = False
            state["failed"] = True
            raise RuntimeError("synthetic device failure")
        return real(*args, **kwargs)

    monkeypatch.setattr(bm, "run_batched", flaky)
    b = _pool(params, cfg, lanes=2, chunk=4)
    try:
        h = b.submit(prime, 10_000, temperature=0.0)
        _wait_for(h, 5)
        state["fail"] = True  # the next kernel call (prime or chunk) raises
        with pytest.raises(RuntimeError, match="synthetic device failure"):
            h.result(timeout=120)
        assert state["failed"]
        _, cls = b.submit(prime, 8, temperature=0.0).result(timeout=120)
        np.testing.assert_array_equal(cls, _solo(params, cfg, prime, 8))
    finally:
        b.close()


def test_stats_counters(tiny):
    cfg, params, _, _ = tiny
    prime = _prime(cfg, 3)
    b = _pool(params, cfg, lanes=3, chunk=6)
    try:
        s0 = b.stats()
        assert s0["lanes"] == 3 and s0["chunk"] == 6
        assert s0["admitted"] == s0["samples_out"] == 0
        h1 = b.submit(prime, 13, temperature=0.0)
        h2 = b.submit(prime, 5, temperature=0.0)
        h1.result(timeout=120)
        h2.result(timeout=120)
        hc = b.submit(prime, 10_000, temperature=0.0)
        _wait_for(hc, 1)
        hc.cancel()
        with pytest.raises(RequestCancelled):
            hc.result(timeout=120)
        s = b.stats()
        assert s["admitted"] == 3 and s["completed"] == 2
        assert s["cancelled"] == 1 and s["failed"] == 0
        assert s["samples_out"] >= 13 + 5 + 1
        assert s["pool_steps"] >= 3 and s["prime_calls"] >= 1
        assert s["active"] == 0 and s["free"] == 3 and s["queued"] == 0
        assert s["pool_clock"] > 0 and s["bytes_down"] > 0
        assert s["outstanding"] == 0
    finally:
        b.close()


def test_close_drain_finishes_accepted_work(tiny):
    """close(drain=True) refuses new submissions but completes every
    accepted request, including one still inside its admission."""
    cfg, params, _, _ = tiny
    prime = np.asarray([cfg.classes // 2], np.int32)
    b = _pool(params, cfg, lanes=2, chunk=6)
    h1 = b.submit(prime, 40, temperature=0.0)
    h2 = b.submit(prime, 25, temperature=0.7, seed=3)
    _wait_for(h1, 1)
    t = threading.Thread(target=b.close, kwargs=dict(drain=True))
    t.start()
    deadline = time.time() + 30
    while not b._draining and time.time() < deadline:
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(prime, 5)
    _, cls1 = h1.result(timeout=120)
    _, cls2 = h2.result(timeout=120)
    t.join(timeout=60)
    assert not t.is_alive()
    np.testing.assert_array_equal(cls2, _solo(params, cfg, prime, 25, 0.7, 3))
    assert cls1.shape == (40,)
    s = b.stats()
    assert s["completed"] == 2 and s["failed"] == 0
    b2 = _pool(params, cfg, lanes=2, chunk=6)
    h = b2.submit(_prime(cfg, 60), 20, temperature=0.0)
    b2.close(drain=True)  # immediately: the admission is still running
    np.testing.assert_array_equal(h.result(timeout=1)[1],
                                  _solo(params, cfg, _prime(cfg, 60), 20))


def test_max_pending_sheds_load(tiny):
    cfg, params, _, _ = tiny
    prime = np.asarray([cfg.classes // 2], np.int32)
    b = _pool(params, cfg, lanes=1, chunk=6, max_pending=2)
    try:
        handles = []
        with pytest.raises(PoolOverloaded):
            for _ in range(12):  # 1 lane: the queue fills within a few
                handles.append(b.submit(prime, 30, temperature=0.0))
        assert handles
        solo = _solo(params, cfg, prime, 30)
        for h in handles:
            np.testing.assert_array_equal(h.result(timeout=120)[1], solo)
        b.submit(prime, 5, temperature=0.0).result(timeout=120)
    finally:
        b.close()


def test_update_params_rolling_swap(tiny):
    cfg, params, cfgj, _ = tiny
    params2 = pt.from_jax_params(_np_params(cfgj, 1), "cpu")
    prime = np.asarray([cfg.classes // 2], np.int32)
    b = _pool(params, cfg, lanes=2, chunk=6)
    try:
        b.submit(prime, 12, temperature=0.0).result(timeout=120)
        b.update_params(params2)
        _, cls = b.submit(prime, 12, temperature=0.0).result(timeout=120)
        np.testing.assert_array_equal(cls, _solo(params2, cfg, prime, 12))
        narrow = pt.get_config("tiny", kernel_size=3, residual_channels=4)
        with pytest.raises(ValueError, match="mismatch"):
            b.update_params(pt.init_wavenet(narrow, torch.Generator(),
                                            "cpu"))
    finally:
        b.close()


def test_single_sample_requests_and_timing(tiny):
    """A single-sample request (its lane frees at admission; its sample is
    the prime's output) completes with the solo value while the pipeline is
    busy, and the lifecycle marks are filled."""
    cfg, params, _, _ = tiny
    prime = _prime(cfg, 3)
    solo = _solo(params, cfg, prime, 3)
    b = _pool(params, cfg, lanes=2, chunk=5)
    try:
        long = b.submit(prime, 30, temperature=0.0)
        _wait_for(long, 6)
        _, cls1 = b.submit(prime, 1, temperature=0.0).result(timeout=120)
        assert cls1.shape == (1,) and cls1[0] == solo[0]
        _, cls_long = long.result(timeout=120)
        np.testing.assert_array_equal(cls_long[:3], solo)
        tm = long.timing
        assert {"t_submit", "t_admitted", "t_first", "prime_s", "splice_s",
                "group"} <= set(tm)
        assert tm["t_submit"] <= tm["t_admitted"] <= tm["t_first"]
    finally:
        b.close()


def test_prewarm_then_serves(tiny):
    cfg, params, _, _ = tiny
    b = _pool(params, cfg, lanes=2, chunk=8)
    try:
        b.prewarm()
        assert b.stats()["pool_steps"] == 0  # warm-up is not counted
        prime = np.asarray([1, 3, 2], np.int32)
        _, c = b.submit(prime, 12, temperature=0.0).result(timeout=120)
        np.testing.assert_array_equal(c, _solo(params, cfg, prime, 12))
        assert b.stats()["prime_calls"] == 1
    finally:
        b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.prewarm()


def test_bad_requests_rejected(tiny):
    cfg, params, _, _ = tiny
    b = _pool(params, cfg, lanes=2, chunk=4)
    try:
        for prime, n in ((np.zeros((2, 3), np.int32), 4), ([1], 0),
                         ([cfg.classes], 4), ([-1], 4), ([0.5], 4), ([], 4)):
            with pytest.raises(ValueError):
                b.submit(prime, n)
    finally:
        b.close()
    with pytest.raises(ValueError):
        _pool(params, cfg, lanes=2, chunk=4, light_chunk=4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ContinuousBatcher(params, cfg, lanes=2, chunk=4)  # default device


def test_deliver_firsts_error_resolves_handles(tiny):
    """An error while waiting for deferred first samples resolves EVERY
    handle of those groups and re-raises for the pool restart; _fail_all
    does not count them twice."""
    cfg, _, _, _ = tiny

    class _Boom:
        def synchronize(self):
            raise RuntimeError("device exploded")

    b = ContinuousBatcher.__new__(ContinuousBatcher)  # no worker thread
    b._t = dict(t_prime_sync=0.0)
    b._n = dict(failed=0, completed=0, cancelled=0, samples_out=0)
    b._active, b._free = [], []
    b._temps = np.zeros(2, np.float32)
    handles = []
    for _ in range(2):
        h = bm.GenerationHandle(1, None)
        h._classes = cfg.classes
        handles.append(h)
    act = SimpleNamespace(remaining=0, lane=0)
    b._deferred = [((torch.zeros(1), _Boom()), [(h, act, 0)])
                   for h in handles]
    with pytest.raises(RuntimeError, match="device exploded"):
        b._deliver_firsts()
    assert b._deferred == []
    for h in handles:
        assert h.done()
        with pytest.raises(RuntimeError, match="device exploded"):
            h.result(timeout=1)
    assert b._n["failed"] == 2
    b.lanes = 2
    b._active = [SimpleNamespace(handle=h) for h in handles]
    b._fail_all(RuntimeError("restart"))
    assert b._n["failed"] == 2
    assert b._active == [] and b._state is None


def test_worker_that_cannot_start_refuses_work(tiny, monkeypatch):
    """A failure while the worker binds its device (no card, a bad device
    index) stops the pool at once: prewarm and submit raise with the cause
    instead of waiting."""
    cfg, params, _, _ = tiny

    def broken(self):
        raise RuntimeError("no such device")

    monkeypatch.setattr(ContinuousBatcher, "_device_context", broken)
    b = _pool(params, cfg, lanes=2, chunk=4)
    b._thread.join(10)
    t = time.time()
    with pytest.raises(RuntimeError, match="closed") as err:
        b.prewarm(timeout=60)
    assert "no such device" in str(err.value.__cause__)
    with pytest.raises(RuntimeError, match="closed"):
        b.submit([1], 4)
    assert time.time() - t < 5
    b.close()


def test_concurrent_submitters_stress(tiny):
    """More submitting threads than cores, with a short switch interval:
    every request completes exactly once and equals its solo rollout, and
    the counters add up (a lost update would break one of them)."""
    import sys

    cfg, params, _, _ = tiny
    prime = np.asarray([cfg.classes // 2], np.int32)
    solo = {seed: _solo(params, cfg, prime, 9, 0.8, seed)
            for seed in range(48)}
    b = _pool(params, cfg, lanes=5, chunk=4)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    got, errors = {}, []
    try:
        def worker(k):
            try:
                for seed in range(k, 48, 16):
                    got[seed] = b.submit(prime, 9, temperature=0.8,
                                         seed=seed).result(timeout=120)[1]
            except BaseException as e:  # reported below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
        b.close()
    assert not errors
    for seed, cls in solo.items():
        np.testing.assert_array_equal(got[seed], cls)
    s = b.stats()
    assert s["admitted"] == s["completed"] == 48 and s["outstanding"] == 0
    assert s["samples_out"] == 48 * 9 and s["failed"] == 0


@pytest.mark.parametrize("primed", [True, False], ids=["primed", "unprimed"])
def test_stats_count_headless_prime_steps(tiny, primed):
    """A prime call runs its ``num_given - 1`` teacher-forced steps without
    the head: ``stats()["headless_steps"]`` adds each request's prime
    length - 1 (0 for a one-class prime), and every request still equals
    its solo rollout."""
    cfg, params, _, _ = tiny
    lengths = (cfg.receptive_field, 5) if primed else (1, 1)
    primes = [_prime(cfg, 30 + i, n) for i, n in enumerate(lengths)]
    b = _pool(params, cfg, lanes=2, chunk=4)
    try:
        handles = [b.submit(p, 9, temperature=0.9, seed=3 + i)
                   for i, p in enumerate(primes)]
        for i, (h, p) in enumerate(zip(handles, primes)):
            _, c = h.result(timeout=120)
            np.testing.assert_array_equal(
                c, _solo(params, cfg, p, 9, temperature=0.9, seed=3 + i))
        assert b.stats()["headless_steps"] == sum(n - 1 for n in lengths)
    finally:
        b.close()
