"""The lane pool on a mesh (``ContinuousBatcher(mesh=)`` on rank 0,
``follow_pool`` on the others) on the CPU: gloo ranks, one process each,
started once per world size by ``torch_pool_mesh_cases`` (no JAX in them);
the comparisons run here.

Tolerances: every response is held bitwise (classes equal) against the
port's one-rank pool and its solo ``generate_fast_batched`` rollout on the
same (prime, temperature, seed, conditioning), and the staggered case
against the JAX package's solo K4 in interpret mode, class for class (its
weights put no top-2 gap near a tie). The block step equals
``sharded_pool_step`` bitwise (classes and rings). Served wavs are
byte-equal to the one-process server's.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt
import torch_parallel_cases as base
import torch_pool_mesh_cases as cases
from pytorch_wavenet_tpu.ops.pallas.gen_kernel_hbm import (
    generate_fast_batched as jax_batched,
)
from pytorch_wavenet_tpu_torch.ops import mel as tmel
from pytorch_wavenet_tpu_torch.serving import ContinuousBatcher
from pytorch_wavenet_tpu_torch.serving import server as srv

REPO = base.REPO
SCRIPT = os.path.abspath(cases.__file__)
WORLDS = (2, 4)
GROUP_TIMEOUT = 150.0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group, started together and run once: the output directory."""
    d = str(tmp_path_factory.mktemp("pool_mesh"))
    started = [base.start("pool", w, d, timeout=GROUP_TIMEOUT, script=SCRIPT)
               for w in WORLDS]
    lost = {g: base.start(g, 2, d, timeout=GROUP_TIMEOUT, script=SCRIPT)
            for g in ("killed", "silent")}
    for run in started:
        base.finish(run)
    return d, {g: base.finish(run, may_fail=(1,)) for g, run in lost.items()}


def _load(runs, case):
    return base.load(runs[0], case)


def _solo(params, cfg, prime, n, temperature=0.0, seed=0, **kw):
    _, cls = pt.generate_fast_batched(
        params, cfg, 0, n, np.asarray(prime)[None], temperature=temperature,
        lane_seed=[seed], device="cpu", **kw)
    return cls[0].numpy()


def _solos(params, cfg, reqs):
    return [_solo(params, cfg, cases.prime(cfg, ps, length), n, temp, seed)
            for ps, length, n, temp, seed, _ in reqs]


def _one_rank(params, cfg, reqs_list, **opts):
    """The same submissions on the port's pool in this process."""
    opts.setdefault("lanes", cases.LANES)
    opts.setdefault("chunk", cases.CHUNK)
    b = ContinuousBatcher(params, cfg, device="cpu", **opts)
    try:
        return [c for reqs in reqs_list
                for c in cases.run_requests(b, cfg, reqs)]
    finally:
        b.close()


def _jax_solos(cfg, reqs):
    """The JAX package's K4 in interpret mode, one call per prime length
    with a lane a request (per-lane temperature and seed; a lane's first n
    samples are its solo rollout of n)."""
    cfgj = wt.get_config("tiny", kernel_size=3)
    jp = jax.tree.map(jnp.asarray, base.params_of(cfg, 0, scale=cases.SCALE))
    out = {}
    by_len: dict = {}
    for i, (ps, length, n, temp, seed, _) in enumerate(reqs):
        by_len.setdefault(length, []).append(i)
    for length, idx in by_len.items():
        primes = np.stack([cases.prime(cfg, reqs[i][0], length) for i in idx])
        n_max = max(reqs[i][2] for i in idx)
        _, cls = jax_batched(
            jp, cfgj, jax.random.PRNGKey(0), n_max, jnp.asarray(primes),
            temperature=jnp.asarray([reqs[i][3] for i in idx], jnp.float32),
            lane_seed=jnp.asarray([reqs[i][4] for i in idx], jnp.int32),
            interpret=True)
        for row, i in enumerate(idx):
            out[i] = np.asarray(cls)[row, :reqs[i][2]]
    return [out[i] for i in range(len(reqs))]


@pytest.mark.parametrize("world", WORLDS)
def test_staggered_and_hot_requests_equal_one_rank(runs, world):
    """(a) Staggered greedy requests admitted mid-flight, seeded hot ones
    and a late one on a reused lane: each equals the one-rank pool's and
    the solo rollout bitwise, on 2 and 4 ranks; every rank stepped."""
    got = _load(runs, f"staggered{world}")
    cfg, params = cases.tiny()
    reqs = cases.STAGGERED + cases.LATE
    one = _one_rank(params, cfg, [cases.STAGGERED, cases.LATE])
    for i, want in enumerate(_solos(params, cfg, reqs)):
        np.testing.assert_array_equal(got[f"cls{i}"], one[i])
        np.testing.assert_array_equal(got[f"cls{i}"], want)
    assert len(set(got["cls2"].tolist())) > 1  # sampled, not greedy
    assert int(got["stats/completed"]) == len(reqs)
    assert int(got["stats/failed"]) == 0
    assert int(got["stats/mesh_ranks"]) == world
    assert int(got["stats/mesh_step_bytes"]) > 0
    for r in range(1, world):
        follower = base.load(runs[0], f"staggered{world}", r)
        assert int(follower["follower/pool_steps"]) == int(
            got["stats/pool_steps"])


def test_staggered_equals_jax_solo(runs):
    """(a) The mesh pool's responses against the JAX package's solo K4
    (interpret mode), class for class."""
    cfg, _ = cases.tiny()
    reqs = cases.STAGGERED + cases.LATE
    want = _jax_solos(cfg, reqs)
    for world in WORLDS:
        got = _load(runs, f"staggered{world}")
        for i, w in enumerate(want):
            np.testing.assert_array_equal(got[f"cls{i}"], w)


def test_refusals(runs):
    """Lanes that do not divide over the data axis are refused on both
    sides with the JAX package's wording; the scheduler lives on rank 0,
    the followers elsewhere."""
    for r in range(2):
        got = base.load(runs[0], "refusals2", r)
        assert "not divisible by the mesh data axis" in str(got["divisible"])
        assert "not divisible by the mesh data axis" in str(
            got["divisible_follower"])
        assert "rank 0" in str(got["wrong_rank"])


def _expanded(frames, total, params):
    need = tmel.frames_window_len(total, cases.HOP, cases.FACTORS)
    idx = np.minimum(np.arange(max(frames.shape[0], need)),
                     frames.shape[0] - 1)
    return tmel.expand_frames_window(
        params, torch.from_numpy(frames[idx])[None], cases.HOP,
        torch.zeros(1, dtype=torch.long), total, cases.FACTORS)[0].numpy()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", ["rows", "frames"])
def test_conditioned_requests_equal_solo(runs, world, mode):
    """(b) Conditioned requests on the mesh pool, per-sample rows or mel
    frames at a bf16 wire expanded by the learnable upsampler on the
    owner's device, equal their solo conditioned rollouts bitwise (frames:
    the bf16-rounded frames expanded over the whole timeline); the
    unconditioned request rides zero rows."""
    frames = mode == "frames"
    got = _load(runs, f"{mode}{world}")
    cfg, params = cases.vocoder(frames)
    up = {"cond_up": params["cond_up"]} if frames else None
    for i, (prime, n, temp, seed, c) in enumerate(
            cases.cond_inputs(cfg, frames)):
        rows = c
        if frames and c is not None:
            rounded = torch.from_numpy(c).to(torch.bfloat16).float().numpy()
            rows = _expanded(rounded, prime.size - 1 + n, up)
        want = _solo(params, cfg, prime, n, temp, seed,
                     cond=None if rows is None else rows[None])
        np.testing.assert_array_equal(got[f"cls{i}"], want)
    assert int(got["stats/failed"]) == 0


@pytest.mark.parametrize("world", WORLDS)
def test_adaptive_chunking_equals_one_rank(runs, world):
    """(c) Light chunks while the pool is lightly loaded, full ones past
    the threshold: every response equals the one-rank pool's and its solo
    rollout bitwise."""
    got = _load(runs, f"light{world}")
    cfg, params = cases.tiny()
    one = _one_rank(params, cfg, [cases.LIGHT], **cases.LIGHT_OPTS)
    for i, want in enumerate(_solos(params, cfg, cases.LIGHT)):
        np.testing.assert_array_equal(got[f"cls{i}"], one[i])
        np.testing.assert_array_equal(got[f"cls{i}"], want)


@pytest.mark.parametrize("world", WORLDS)
def test_update_params_reaches_every_rank(runs, world):
    """(d) ``update_params`` mid-stream: the event is set, and requests
    sent after it, on lanes of every rank, equal their solo rollouts on the
    new weights bitwise."""
    got = _load(runs, f"update{world}")
    cfg, _ = cases.tiny()
    assert bool(got["installed"])
    for i, want in enumerate(_solos(cases.tiny_b(cfg), cfg, cases.UPDATE)):
        np.testing.assert_array_equal(got[f"cls{i}"], want)
    assert int(got["stats/failed"]) == 0
    assert int(got["stats/mesh_params_bytes"]) > 0


@pytest.mark.parametrize("world", WORLDS)
def test_follower_block_step_equals_sharded_pool_step(runs, world):
    """(e) The follower's block step, chained twice, equals
    ``sharded_pool_step`` on the same blocks bitwise: classes, rings and
    the clock."""
    got = _load(runs, f"block{world}")
    for i in range(2):
        np.testing.assert_array_equal(got[f"cls{i}"], got[f"ref{i}"])
        np.testing.assert_array_equal(got[f"ring{i}"], got[f"ref_ring{i}"])
        assert got[f"clock{i}"][0] == got[f"clock{i}"][1]


def test_follower_failure_fails_riders_then_serves(runs):
    """(f) A follower whose kernel call raises fails every rider on rank 0
    with its error; after RESET the pool serves a request equal to its
    solo rollout."""
    got = _load(runs, "raises2")
    cfg, params = cases.tiny()
    errors = [str(e) for e in got["errors"]]
    assert all("synthetic follower failure" in e and "rank 1" in e
               for e in errors), errors
    np.testing.assert_array_equal(
        got["after"], _solo(params, cfg, cases.prime(cfg, 64), 15))
    assert int(got["stats/failed"]) == 3


def test_dead_follower_resolves_every_handle(runs):
    """(f) A follower that dies mid-stream: every handle on rank 0 resolves
    with the error well within the pool's MESH_TIMEOUT, and the pool then
    refuses work instead of running on one rank."""
    got = _load(runs, "killed2")
    assert runs[1]["killed"] == [0, 3]  # the follower exited where killed
    errors = [str(e) for e in got["errors"]]
    assert all("gone or silent" in e for e in errors), errors
    assert float(got["elapsed"]) < cases.KILL_TIMEOUT + 10
    assert "closed" in str(got["refused"])


def test_silent_follower_resolves_every_handle(runs):
    """(f) A follower that is alive but silent (asleep in a kernel call
    past MESH_TIMEOUT): rank 0's wait for its reply times out, so every
    handle resolves with the error within the limit (a few seconds more:
    the steps before it) and before the follower wakes, and the pool then
    refuses work. The follower fails once rank 0 has left."""
    got = _load(runs, "silent2")
    assert runs[1]["silent"][0] == 0
    errors = [str(e) for e in got["errors"]]
    assert all("gone or silent" in e
               and f"waited up to {cases.SILENT_TIMEOUT:g} s" in e
               for e in errors), errors
    assert cases.SILENT_TIMEOUT <= float(got["elapsed"]) \
        < cases.SILENT_TIMEOUT + 8 < cases.SILENT_SLEEP
    assert "closed" in str(got["refused"])


def test_close_drain_finishes_and_followers_return(runs):
    """(g) ``close(drain=True)`` right after the submissions completes
    every accepted request, and the follower's loop returns."""
    got = _load(runs, "drain2")
    cfg, params = cases.tiny()
    for i, want in enumerate(_solos(params, cfg, cases.DRAIN)):
        np.testing.assert_array_equal(got[f"cls{i}"], want)
    assert int(got["completed"]) == len(cases.DRAIN)
    follower = base.load(runs[0], "drain2", 1)
    assert int(follower["follower/pool_steps"]) > 0


# ------------------------------------------------ the entry points, torchrun


def _torchrun(module, args, **kw):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", module] + args
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, **kw)


def _wav(base_url, body):
    req = urllib.request.Request(
        base_url + "/synthesize", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read()


def _fetch_all(base_url, bodies):
    out = [None] * len(bodies)

    def fetch(i):
        out[i] = _wav(base_url, bodies[i])

    threads = [threading.Thread(target=fetch, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    return out


SERVE = ["--batcher", "--lanes", "4", "--batch-chunk", "16", "--device",
         "cpu", "--port", "0"]


def test_server_on_two_ranks_equals_one_process(tmp_path):
    """(h) ``serving.server --batcher --mesh-data 2`` under torchrun: two
    seeded /synthesize requests give wavs byte-equal to the one-process
    server's; SIGINT to rank 0 stops both ranks cleanly. A 2-rank launch
    without --batcher is refused."""
    cfg = pt.get_config("tiny")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(3), "cpu")
    path = pt.save_checkpoint(str(tmp_path), "tiny", 7, params, cfg=cfg)
    prime = np.random.default_rng(8).integers(0, cfg.classes, 9).tolist()
    bodies = [{"num_samples": 70, "temperature": 0.0, "seed": 1},
              {"num_samples": 45, "temperature": 0.9, "seed": 2,
               "prime": prime}]
    refused = _torchrun("pytorch_wavenet_tpu_torch.serving.server",
                        ["--snapshot", path, "--device", "cpu", "--port",
                         "0"])
    proc = _torchrun("pytorch_wavenet_tpu_torch.serving.server",
                     ["--snapshot", path, "--mesh-data", "2"] + SERVE)
    box, ready = {}, threading.Event()

    def on_ready(server):
        box["server"] = server
        ready.set()

    th = threading.Thread(target=srv.main, kwargs=dict(
        argv=["--snapshot", path] + SERVE, on_ready=on_ready), daemon=True)
    th.start()
    try:
        assert ready.wait(60)
        one = box["server"]
        want = _fetch_all(f"http://127.0.0.1:{one.server_address[1]}",
                          bodies)
    finally:
        box["server"].shutdown()
        th.join(30)
    lines, url, pid = [], None, None
    deadline = time.time() + 120
    while (url is None or pid is None) and time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        if "(pid " in line:
            pid = int(line.split("(pid ")[1].split(")")[0])
        if "serving " in line and "http://" in line:
            url = line.split("http://")[1].split()[0]
    try:
        assert url and pid, "".join(lines)
        got = _fetch_all(f"http://{url}", bodies)
        stats = json.loads(urllib.request.urlopen(
            f"http://{url}/stats", timeout=60).read())
    finally:
        if pid:
            os.kill(pid, signal.SIGINT)
        rest, _ = proc.communicate(timeout=120)
    out = "".join(lines) + rest
    assert proc.returncode == 0, out[-4000:]
    assert got == want
    assert stats["mesh_ranks"] == 2 and stats["completed"] >= 2
    assert "kernel launches per rank: K4 [0, 0]" in out  # plain on the CPU
    steps = json.loads(out.split("pool steps per rank: ")[1].split(";")[0])
    assert steps[0] == steps[1] == stats["pool_steps"] > 0
    out, _ = refused.communicate(timeout=120)
    assert refused.returncode != 0 and "without --batcher" in out


def test_serving_bench_on_two_ranks(tmp_path):
    """(i) ``serving_bench --mesh-data 2`` under torchrun prints its JSON
    line with every request completed and the cross-rank bytes."""
    proc = _torchrun("pytorch_wavenet_tpu_torch.scripts.serving_bench",
                     ["--config", "tiny", "--lanes", "4", "--chunk", "16",
                      "--concurrency", "3", "--requests", "6",
                      "--num-samples", "40", "--device", "cpu",
                      "--mesh-data", "2", "--json"])
    out, _ = proc.communicate(timeout=180)
    assert proc.returncode == 0, out[-4000:]
    line = [x for x in out.splitlines() if x.startswith("{")][-1]
    summary = json.loads(line)
    assert summary["completed"] == summary["requests"] == 6
    assert summary["failed"] == 0 and summary["mesh_ranks"] == 2
    assert summary["mesh_step_bytes"] > 0 and summary["t_gather"] >= 0
