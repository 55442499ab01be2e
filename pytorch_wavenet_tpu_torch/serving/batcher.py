"""Continuous batching for autoregressive generation.

The counterpart of the JAX package's ``serving/batcher.py``. ONE
persistent multi-stream rollout stays alive on
the device, a lane pool over :func:`ops.cuda.gen_kernel_hbm.
generate_fast_batched`'s streaming state (the kernel K4 on a card, its
plain version on the CPU), and requests are spliced in and out at chunk
boundaries:

* every lane of the shared :class:`HbmGenState` is a slot; free lanes run
  greedy on stale state (lanes are independent in the kernel);
* a new request is primed by a kernel call of its own; its ring column is
  zero-filled where the prime never wrote, **roll-aligned** from its local
  clock to the pool's clock (ring slot = t mod period, so re-basing t is a
  per-layer roll of the slot axis) and scattered into the shared ring, all
  by indexing on the device;
* each request carries its own temperature and its own seed, counted off
  its OWN step clock (the kernel's ``lane_seed``/``lane_clock``), so even
  hot rollouts are reproducible;
* outputs are handed out per chunk, so callers stream audio while later
  requests keep joining;
* each lane carries its own conditioning timeline (the vocoder), in one of
  two modes: per-sample rows (``submit(cond=)``), or, on a pool built with
  ``cond_hop``, mel frames (``submit(cond_frames=)``) of which each chunk
  ships only the lane's window, expanded to sample rate on the device
  (``ops.mel.expand_frames_window``, bitwise the same for every chunking),
  at ``cond_wire_dtype`` (f32, or bf16 to halve the upload). Unconditioned
  requests on a conditioned pool ride zero rows.

Admission is exact at every temperature: a request's rollout is bitwise
identical to a solo ``generate_fast_batched`` call with ``lane_seed=[seed]``
at the same (prime, temperature), whenever it is admitted and whatever
shares the pool.

All device work runs on one worker thread, on one CUDA stream. The worker
keeps one chunk in flight: it launches chunk i+1, enqueues its
device-to-host copy (classes narrowed to the wire dtype) into pinned
memory and records an event, and only then waits for chunk i's event and
hands chunk i out, so host delivery overlaps the next device step. First
samples of an admission are copied and awaited the same way. Uploads go
through pinned memory without blocking, and the kernel's weight operands
are prepared once per parameter version.

The pool's ring is f32 or bf16 (``ring_dtype``, the server's
``--bf16-rings``); a prime's ring, the bootstrap ring and the admission
splice keep that dtype, so a pooled request equals its solo rollout at the
same ring dtype. int8 rings, which need calibrated scales, are not taken
(nor does the JAX package's batcher pass scales).

**The pool on a mesh** (``mesh=``, a data-axis mesh from
``parallel.mesh.make_mesh``): the lanes split into one block per rank,
global lane g on rank ``g // (lanes / data)``. Rank 0 builds the
:class:`ContinuousBatcher` and is the scheduler: it owns the request
queue, the pool clock and delivery. Every other rank runs
:func:`follow_pool` (``serving/_mesh_pool.py``), a loop over rank 0's
messages. Each rank holds its own block's ring and K4's operands and runs
the same step, prime, splice and frame-expansion code (the
:class:`_LaneWork` base of both sides); each pool step is one K4 launch a
rank on its block. Only what a step needs crosses ranks: a fixed header
(the chunk width, the clock) and the block's lane rows when they changed;
an admission's prime classes, temperature and seed go to the lane's owner,
which primes and splices on its own device (ring columns never cross);
conditioning goes to the owner only (rows, or frame slabs at the wire
dtype); each follower sends its block's classes, in the wire dtype, to
rank 0 alone. Rank 0 waits for them where it waits for its own copy, so
one chunk stays in flight. Weights cross at install: rank 0 sends its
params at first use and at every ``update_params``, whose event is set
once every rank has installed them. A follower's failure fails the riders
and every rank re-bootstraps; a follower that dies stops the pool with
the error within ``MESH_TIMEOUT`` seconds. Responses are bitwise those of one
rank. The TPU's width bucketing, its multiple-of-128 lane checks and the
compiles ``prewarm`` existed for have no counterpart: a prime runs a group
at its own size.
"""

from __future__ import annotations

import queue
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np
import torch

from ..config import WaveNetConfig
from ..device import resolve_device
from ..models.wavenet import Params, params_to
from ..ops.cuda.gen_kernel_hbm import (
    HbmGenState,
    periods,
    prepare_weights,
    ring_offsets,
    ring_rows,
    run_batched,
)
from ..ops.mel import expand_frames_window, frames_window_len
from ..ops.mulaw import dequantize_to_f32
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_size
from ..parallel.sharding import batch_sharding


# seconds rank 0 waits for a follower's reply (and a follower for rank 0's
# next message) before the pool on a mesh stops with an error, read when
# either side is built; the server and serving_bench make it their process
# group's timeout too
MESH_TIMEOUT = 300.0


class RequestCancelled(RuntimeError):
    """Raised by :meth:`GenerationHandle.result` after ``cancel()``."""


class PoolOverloaded(RuntimeError):
    """Raised by :meth:`ContinuousBatcher.submit` when the waiting queue is
    at ``max_pending``: shed load instead of buffering without bound (the
    server maps this to HTTP 503)."""


class GenerationHandle:
    """Caller-side view of a submitted request."""

    def __init__(self, num_samples: int, on_chunk=None):
        self.num_samples = num_samples
        self._on_chunk = on_chunk
        self._parts: list[np.ndarray] = []
        self._done = threading.Event()
        self._cancel = threading.Event()
        self._error: BaseException | None = None
        self._on_done = None  # batcher bookkeeping hook, fired exactly once
        # lifecycle marks filled by the batcher: t_submit, t_admitted,
        # t_first (perf_counter), prime_s/splice_s (its admission group's
        # host dispatch costs) and group (the burst size)
        self.timing: dict = {}

    def _deliver(self, cls_chunk: np.ndarray):
        self._parts.append(cls_chunk)
        if self._on_chunk is not None:
            self._on_chunk(cls_chunk)

    def _finish(self, error: BaseException | None = None):
        if self._done.is_set():  # idempotent: worker drain + close() drain
            return
        self._error = error
        self._done.set()
        if self._on_done is not None:
            self._on_done()

    def done(self) -> bool:
        return self._done.is_set()

    def cancel(self):
        """Ask the batcher to drop this request at the next chunk boundary,
        freeing its lane. No-op once complete; after it takes effect,
        ``result()`` raises :class:`RequestCancelled`."""
        self._cancel.set()

    def cancelled(self) -> bool:
        return self._cancel.is_set()

    def result(self, timeout: float | None = None):
        """Block until complete; returns ``(waveform (N,) float32,
        classes (N,) int32)``."""
        if not self._done.wait(timeout):
            raise TimeoutError("generation not complete")
        if self._error is not None:
            raise self._error
        cls = np.concatenate(self._parts)[: self.num_samples]
        return dequantize_to_f32(cls, self._classes), cls


@dataclass(eq=False)  # identity semantics: instances ride snapshot lists
class _Active:
    handle: GenerationHandle
    lane: int
    remaining: int
    # rows mode: the per-sample rows not consumed yet (k, M); frames mode
    # (pool cond_hop set): the request's whole frame timeline (F, M), with
    # cond_off the next sample-rate row to consume
    cond: np.ndarray | None = None
    cond_off: int = 0


@dataclass
class _Pending:
    handle: GenerationHandle
    prime: np.ndarray
    temperature: float
    seed: int = 0
    cond: np.ndarray | None = None  # rows, or frames on a cond_hop pool


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _data_blocks(mesh, lanes: int) -> tuple[int, int]:
    """``(ranks on the data axis, lanes a rank)`` of a pool of ``lanes``
    over ``mesh`` (``(1, lanes)`` without one); refuses what does not
    split into equal blocks over data alone."""
    n = axis_size(mesh, DATA_AXIS)
    if axis_size(mesh, MODEL_AXIS) != 1:
        raise ValueError("the lane pool splits over the mesh data axis "
                         "only; its model axis must have size 1")
    if lanes % n:
        raise ValueError(f"lanes={lanes} not divisible by the mesh data axis "
                         f"({n} ranks)")
    rows = batch_sharding(mesh, lanes)
    return n, rows.stop - rows.start


class _LaneWork:
    """The device side of a lane pool, on one rank's block of
    ``self._width`` lanes: the kernel's operands, the block's state and
    clock mirror, and the prime, splice, frame expansion and pool step.
    :class:`ContinuousBatcher` (rank 0, or the whole pool on one rank) and
    the mesh's followers run this one copy."""

    _stream = None

    def _configure(self, params, cfg: WaveNetConfig, lanes: int, chunk: int,
                   light_chunk, cond_hop, cond_wire_dtype, ring_dtype,
                   device, fuse_res: bool, skip_slab: bool,
                   regularize: float):
        """Check the pool's options and set the block's fields (its width
        ``_width`` is the caller's to set)."""
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if lanes < 1 or chunk < 1:
            raise ValueError(f"lanes={lanes} and chunk={chunk} must be >= 1")
        if light_chunk is not None and not (1 <= light_chunk < chunk):
            raise ValueError(
                f"light_chunk={light_chunk} must be in [1, chunk={chunk})")
        self.cond_hop = cond_hop
        self._factors: tuple[int, ...] = ()
        if cond_hop is not None:
            if cfg.cond_channels == 0:
                raise ValueError("cond_hop needs cfg.cond_channels > 0")
            if cond_hop < 1:
                raise ValueError(f"cond_hop must be >= 1, got {cond_hop}")
            if cfg.cond_upsample and "cond_up" in params:
                total = int(np.prod(cfg.cond_upsample))
                if total != cond_hop:
                    raise ValueError(
                        f"cond_upsample factors {cfg.cond_upsample} "
                        f"multiply to {total} != cond_hop {cond_hop}")
                self._factors = tuple(cfg.cond_upsample)
        if cond_wire_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"cond_wire_dtype must be float32 or bfloat16, "
                             f"not {cond_wire_dtype}")
        if ring_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"ring_dtype must be float32 or bfloat16, not "
                             f"{ring_dtype}")
        self.ring_dtype = ring_dtype
        self._cond_wire = cond_wire_dtype
        self._cond_up = None  # the upsampler's weights on the device
        self.cfg = cfg
        self.params = params  # installed on the device by the worker
        self.lanes = lanes
        self.chunk = chunk  # the pool clock is int32: ~2^31 samples a pool
        self._kw = dict(fuse_res=fuse_res, skip_slab=skip_slab,
                        regularize=float(regularize))
        self._periods = periods(cfg)
        self._state: HbmGenState | None = None  # created lazily
        self._w = None  # the kernel's operands for the current params
        self._rowmap = None  # per-ring-row layer constants for the splice
        # host mirror of the pool clock (state.t): bootstrap value + chunk
        # per pool step
        self._clock = 0
        # device copies of the block's per-lane step rows; they change only
        # at admission, completion and cancel
        self._dev_args = None
        self._host_args = None

    def _global_t(self) -> int:
        # host mirror: reading state.t never waits for the device
        return 0 if self._state is None else self._clock

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        """A host array on the pool's device. On a card the copy goes
        through pinned memory without blocking: a copy from pageable memory
        would wait for the chunk in flight."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == "cpu":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def _download(self, x: torch.Tensor):
        """Start ``x``'s copy to the host; returns ``(host tensor, event)``
        (event None on the CPU). Read the host tensor only after
        :meth:`_wait`."""
        if self.device.type == "cpu":
            return x.clone(), None
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(self._stream)
        return host, ev

    @staticmethod
    def _wait(pending) -> np.ndarray:
        host, ev = pending
        if ev is not None:
            ev.synchronize()
        return host.numpy()

    def _install_params(self, params):
        """Move ``params`` to the device and prepare the kernel's operands
        (once per parameter version)."""
        self.params = params
        dev_params = params_to(params, self.device)
        self._w = prepare_weights(dev_params, self.cfg,
                                  self._kw["fuse_res"], self._kw["skip_slab"],
                                  self.ring_dtype)
        if self._factors:
            self._cond_up = {"cond_up": dev_params["cond_up"]}

    def _step(self, prime, ring, t0, total, temps, seeds, toffs, cond=None):
        """One kernel call; ``cond`` ``(lanes, total, M)`` rows or None."""
        if cond is not None:
            cond = cond.permute(1, 2, 0).contiguous()  # (total, M, lanes)
        return run_batched(self._w, self.cfg, prime, ring, t0, total, temps,
                           seeds, toffs, 0, self._kw["regularize"],
                           self._kw["fuse_res"], self._kw["skip_slab"], True,
                           cond=cond)

    def _frame_window(self, frames: np.ndarray, off: int, count: int):
        """The frame slab and phase that expand a timeline's rows ``[off,
        off + count)``: frames from ``off // hop`` on, the last one
        replicated past the timeline's end."""
        hop = self.cond_hop
        Fs = frames_window_len(count, hop, self._factors)
        fs = off // hop
        idx = np.minimum(fs + np.arange(Fs), frames.shape[0] - 1)
        return frames[idx], off - fs * hop

    def _wire_frames(self, slabs: list) -> torch.Tensor:
        """Frame slabs ``(len(slabs), Fs, M)`` at the wire dtype (host)."""
        wire = torch.from_numpy(np.ascontiguousarray(np.stack(slabs)))
        return wire.to(self._cond_wire)

    def _expand_wire(self, wire: torch.Tensor, phases, count: int
                     ) -> torch.Tensor:
        """Upload frame slabs at the wire dtype and expand them to
        ``(len(wire), count, M)`` f32 rows on the device."""
        self._n["bytes_up"] += wire.numel() * wire.element_size()
        dev = (wire.clone() if self.device.type == "cpu"
               else wire.pin_memory().to(self.device, non_blocking=True))
        phase = self._upload(np.asarray(phases, np.int64))
        return expand_frames_window(self._cond_up, dev.to(torch.float32),
                                    self.cond_hop, phase, count,
                                    self._factors)

    def _expand(self, slabs: list, phases: list, count: int) -> torch.Tensor:
        return self._expand_wire(self._wire_frames(slabs), phases, count)

    def _cond_host(self, count: int, riders):
        """The host side of one call's conditioning: ``(rows, payload)``
        for ``riders`` (``(row, _Active)``), advancing them: ``payload`` is
        ``(their next count rows (k, count, M) f32,)``, or on a frames pool
        ``(frame slabs at the wire dtype, phases)``."""
        idx = np.asarray([row for row, _ in riders], np.int64)
        if self.cond_hop is None:
            rows = np.zeros((len(riders), count, self.cfg.cond_channels),
                            np.float32)
            for i, (_, act) in enumerate(riders):
                k = min(count, act.cond.shape[0])
                rows[i, :k] = act.cond[:k]
                act.cond = act.cond[k:]
            return idx, (rows,)
        windows = [self._frame_window(act.cond, act.cond_off, count)
                   for _, act in riders]
        for _, act in riders:
            act.cond_off += count
        return idx, (self._wire_frames([w for w, _ in windows]),
                     np.asarray([p for _, p in windows], np.int64))

    def _cond_device(self, lanes: int, count: int, idx, payload
                     ) -> torch.Tensor:
        """``(lanes, count, M)`` conditioning rows on the device from
        :meth:`_cond_host`'s parts: its rows (or the frames expanded) at
        rows ``idx``, zeros elsewhere."""
        M = self.cfg.cond_channels
        if self.cond_hop is None:
            rows = np.zeros((lanes, count, M), np.float32)
            rows[idx] = payload[0]
            self._n["bytes_up"] += rows.nbytes
            return self._upload(rows)
        rows = self._expand_wire(payload[0], payload[1], count)
        full = torch.zeros((lanes, count, M), dtype=torch.float32,
                           device=self.device)
        return full.index_copy_(0, self._upload(np.asarray(idx, np.int64)),
                                rows)

    def _chunk_cond(self, lanes: int, count: int, riders) -> torch.Tensor:
        """``(lanes, count, M)`` conditioning rows of one call: each
        conditioned rider's next ``count`` rows at its row (``riders``:
        ``(row, _Active)``), zeros elsewhere; advances the riders."""
        return self._cond_device(lanes, count,
                                 *self._cond_host(count, riders))

    def _prime_block(self, primes: np.ndarray, temps: np.ndarray,
                     seeds: np.ndarray, cond=None):
        """Prime ``primes`` ``(k, ng)`` in ONE kernel call at its own size
        (``cond``: :meth:`_cond_host`'s parts for the prime's rows, or
        None). Returns (ring columns (rows, k), their shared local clock t,
        first samples (k,) on the device: each request's output sample
        0)."""
        ng = primes.shape[1]
        prime = self._upload(primes)
        temps = self._upload(temps)
        seeds = self._upload(seeds)
        toffs = torch.zeros(len(primes), dtype=torch.int32, device=self.device)
        ring = torch.empty((ring_rows(self.cfg), len(primes)),
                           dtype=self.ring_dtype, device=self.device)
        if cond is not None:  # the prime consumes rows [0, ng)
            cond = self._cond_device(len(primes), ng, *cond)
        self._n["prime_calls"] += 1
        self._n["bytes_up"] += prime.numel() * 4
        t0 = time.perf_counter()
        cls = self._step(prime, ring, 0, ng, temps, seeds, toffs, cond)
        self._t["t_prime_dispatch"] += time.perf_counter() - t0
        # the local clock is deterministic (ng - 1 ingested + 1 generated):
        # nothing here waits for the device
        return ring, ng, cls[:, ng - 1].contiguous()

    def _splice_rows(self):
        """Per ring row (layer l, slot s, channel r): the layer's first
        slot, its period, s and r, as device tensors (built once)."""
        if self._rowmap is None:
            R = self.cfg.residual_channels
            first, per, slot = [], [], []
            for f, P in zip(ring_offsets(self.cfg), self._periods):
                first += [f] * P * R
                per += [P] * P * R
                slot += np.repeat(np.arange(P), R).tolist()
            r = np.tile(np.arange(R), sum(self._periods))
            self._rowmap = tuple(self._upload(np.asarray(a, np.int64))
                                 for a in (first, per, slot, r))
        return self._rowmap

    def _align_and_insert(self, primed: torch.Tensor, t_local: int,
                          lanes: list[int], firsts: torch.Tensor):
        """The admission splice, on the device: re-base each layer's ring
        slots from the request-local clock to the pool's (slot = t mod P,
        so shifting the clock by delta gathers slot ``(s - delta) mod P``),
        zero the slots a short prime never wrote (slot s of a period-P ring
        was written iff s < t_local when t_local < P: a select, so whatever
        an unwritten slot holds never reaches the pool), and scatter the
        columns into the block's ring at the target lanes (block columns);
        ``firsts`` become the lanes' next inputs."""
        first, per, slot, r = self._splice_rows()
        R = self.cfg.residual_channels
        t0 = time.perf_counter()
        src_slot = torch.remainder(slot - (self._global_t() - t_local), per)
        written = src_slot < torch.clamp(per, max=t_local)
        cols = primed.index_select(0, (first + src_slot) * R + r)
        cols = torch.where(written[:, None], cols, 0.0)
        idx = self._upload(np.asarray(lanes, np.int64))
        self._state.ring.index_copy_(1, idx, cols)
        self._state.cls.index_copy_(0, idx, firsts)
        self._t["t_splice"] += time.perf_counter() - t0

    def _prime_into(self, cols: list[int], primes: np.ndarray,
                    temps: np.ndarray, seeds: np.ndarray, cond=None):
        """An admission on this block: prime ``primes`` (:meth:`_prime_block`)
        and splice them into the block's columns ``cols`` at its clock.
        Returns the pending copy of their first samples."""
        ring, t_local, firsts = self._prime_block(primes, temps, seeds, cond)
        self._align_and_insert(ring, t_local, cols, firsts)
        return self._download(firsts)

    def _ensure_state(self):
        """Bootstrap the block's state: an all-zero ring with the pool
        clock already PAST every warm-up predicate. The kernel gates a tap
        with lookback m on ``ta >= m``; a pool admits lanes at any clock, so
        those predicates must never fire again: starting at t = max(period)
        makes them always true, and missing history is represented by
        zeroed ring slots instead, which is what the predicate would have
        contributed."""
        if self._state is not None:
            return
        self._clock = max(self._periods)
        self._state = HbmGenState(
            ring=torch.zeros((ring_rows(self.cfg), self._width),
                             dtype=self.ring_dtype, device=self.device),
            t=self._clock,
            cls=torch.full((self._width,), self.cfg.classes // 2,
                           dtype=torch.int32, device=self.device),
        )

    def _step_pool(self, n: int, temps, seeds, toffs,
                   cond=None) -> torch.Tensor:
        """One pool step of ``n`` samples on the block's state, in place;
        advances the host clock mirror. Returns the classes (lanes of the
        block, n) on the device."""
        st = self._state
        cls = self._step(st.cls.view(-1, 1), st.ring, st.t, n, temps, seeds,
                         toffs, cond)
        self._state = HbmGenState(st.ring, st.t + n,
                                  cls[:, n - 1].contiguous())
        self._clock += n  # admissions after this launch rebase against it
        return cls

    def _device_rows(self, temps, seeds, toffs):
        """The block's per-lane temperature, seed and clock rows on the
        device, uploaded again only when they changed."""
        if self._host_args is None or not (
                np.array_equal(temps, self._host_args[0])
                and np.array_equal(seeds, self._host_args[1])
                and np.array_equal(toffs, self._host_args[2])):
            self._host_args = (temps.copy(), seeds.copy(), toffs.copy())
            self._dev_args = tuple(self._upload(a) for a in self._host_args)
            self._n["bytes_up"] += sum(a.nbytes for a in self._host_args)
        return self._dev_args

    def _wire_dtype(self):
        """Narrowest dtype that holds a class id: the device-to-host chunk
        copy shrinks 4x for 256-class models (uint8); the host widens it
        again on delivery."""
        if self.cfg.classes <= 256:
            return torch.uint8
        if self.cfg.classes <= 32768:
            return torch.int16
        return torch.int32

    def _prewarm_block(self):
        """Step the block once with and without conditioning (and expand a
        frame window on a frames pool), on the current lane rows; the clock
        advances by ``chunk`` a step, on every rank alike."""
        self._ensure_state()
        conds = [None]
        if self.cfg.cond_channels:
            conds.append(torch.zeros(
                (self._width, self.chunk, self.cfg.cond_channels),
                device=self.device))
            if self.cond_hop is not None:  # the expansion too
                frames = np.zeros((self.chunk // self.cond_hop + 1,
                                   self.cfg.cond_channels), np.float32)
                self._expand([self._frame_window(frames, 0, self.chunk)[0]],
                             [0], self.chunk)
        for cond in conds:
            cls = self._step_pool(self.chunk, *self._lane_args(), cond=cond)
            self._wait(self._download(cls[:, -1]))

    def _device_context(self):
        """Bind the calling thread to the pool's device and one stream."""
        if self.device.type != "cuda":
            return nullcontext()
        torch.cuda.set_device(self.device)
        self._stream = torch.cuda.Stream(self.device)
        return torch.cuda.stream(self._stream)


class ContinuousBatcher(_LaneWork):
    """A persistent lane pool over the batched generation kernel.

    ``lanes`` is the pool's stream width (any count >= 1). ``chunk`` is the
    splice granularity: requests join and leave every ``chunk`` samples,
    which is also a streaming consumer's time to first audio.
    ``light_chunk`` (< ``chunk``) is dispatched instead while at most
    ``light_threshold * lanes`` requests are active or waiting; outputs do
    not depend on the chunk widths.

    ``submit`` only enqueues; all device work happens on one background
    thread. ``close()`` abandons outstanding handles with a RuntimeError;
    ``close(drain=True)`` finishes accepted work first.

    On ``device="cpu"`` the pool runs the kernel's plain version; on a CUDA
    device it launches the kernel, and a failed build or launch fails the
    riders (the pool restarts) rather than falling back.

    ``mesh``: a data-axis mesh over the process group (the module
    docstring); ``lanes`` is the pool's total, split into equal blocks.
    Build the batcher on global rank 0 and call :func:`follow_pool` with
    the same options on every other rank; a follower silent for
    ``MESH_TIMEOUT`` seconds stops the pool with an error. Without a mesh,
    or on a mesh of one rank, the pool runs on this process alone."""

    _link = None  # the followers on a mesh of more than one rank

    def __init__(self, params: Params, cfg: WaveNetConfig, *, lanes: int = 128,
                 chunk: int = 128, seed: int = 0, fuse_res: bool = False,
                 skip_slab: bool = False, regularize: float = 0.0,
                 max_pending: int | None = None,
                 light_chunk: int | None = None,
                 light_threshold: float = 0.25,
                 cond_hop: int | None = None,
                 cond_wire_dtype: torch.dtype = torch.float32,
                 ring_dtype: torch.dtype = torch.float32,
                 device: str | torch.device = "cuda",
                 mesh=None):
        """``cond_hop``: the pool takes mel frames at this hop
        (``submit(cond_frames=)``); with the model's learnable upsampler
        its factors must multiply to it. ``cond_wire_dtype``: f32, or
        bf16, which halves the frames' upload and makes a response equal
        the solo rollout of bf16-rounded frames. ``ring_dtype``: the pool
        ring's dtype, f32 or bf16 (half the ring's bytes)."""
        self._configure(params, cfg, lanes, chunk, light_chunk, cond_hop,
                        cond_wire_dtype, ring_dtype, device, fuse_res,
                        skip_slab, regularize)
        self.mesh = mesh
        n_data, self._width = _data_blocks(mesh, lanes)
        self.light_chunk = light_chunk
        self.light_threshold = float(light_threshold)
        self.max_pending = max_pending
        self._submit_q: "queue.Queue[_Pending]" = queue.Queue()
        self._active: list[_Active] = []
        self._free = list(range(lanes))
        self._temps = np.zeros(lanes, np.float32)
        # per-lane noise counters: each lane draws from its request's seed
        # at its request-local clock (pool clock + toff)
        self._seeds = np.zeros(lanes, np.int32)
        self._toffs = np.zeros(lanes, np.int32)
        self._auto_seed = int(seed) & 0xFFFFFFFF
        # observability counters (worker-thread writes; stats() reads a
        # consistent-enough snapshot for monitoring)
        self._n = dict(admitted=0, completed=0, cancelled=0, failed=0,
                       samples_out=0, pool_steps=0, prime_calls=0,
                       bytes_down=0, bytes_up=0)
        # cumulative worker-loop phase seconds (host clock): dispatch,
        # chunk delivery, admission, idle; t_prime_dispatch is the prime's
        # enqueue, t_prime_sync the wait for its first samples. All keys
        # pre-seeded: stats() iterates this dict from other threads.
        self._t = dict(t_dispatch=0.0, t_deliver=0.0, t_admit=0.0,
                       t_idle=0.0, t_prime_dispatch=0.0, t_prime_sync=0.0,
                       t_splice=0.0)
        if n_data > 1:
            from ._mesh_pool import Followers

            self._link = Followers(mesh, self._width)
        # events of update_params waiting for the install (on every rank)
        self._installing: list[threading.Event] = []
        # accepted-but-unfinished requests (queue, in admission, active):
        # the drain condition
        self._outstanding = 0
        self._count_lock = threading.Lock()
        self._wake = threading.Event()
        self._closing = False
        self._draining = False
        self._error: BaseException | None = None  # why the worker stopped
        # pending update_params swap: (params, event set once installed)
        self._staged_params = None
        self._prewarm_q: "queue.Queue[tuple]" = queue.Queue()
        # admission groups whose first samples are still on their way to
        # the host: [((host tensor, event), [(handle, act, row), ...]), ...]
        self._deferred: list = []
        # serializes the _closing check against close()'s final drain
        self._lifecycle = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="wavenet-batcher")
        self._thread.start()

    # ------------------------------------------------------------- client

    def submit(self, prime, num_samples: int, temperature: float = 1.0,
               on_chunk=None, seed: int | None = None, cond=None,
               cond_frames=None) -> GenerationHandle:
        """Queue a request. ``prime`` is an int class sequence
        ``(num_given,)`` (at least 1 sample; ``classes // 2`` for an
        unprimed stream). ``on_chunk(cls_chunk)`` fires from the batcher
        thread as samples appear.

        ``cond``: per-sample conditioning rows ``(num_given - 1 +
        num_samples, cond_channels)`` (row t conditions the step that
        consumes input sample t), on pools without ``cond_hop``.
        ``cond_frames``: frames ``(F, cond_channels)`` with ``F >=
        ceil((num_given - 1 + num_samples) / cond_hop)``, on pools with
        ``cond_hop``; the response equals a solo rollout whose rows are
        the frames expanded over the whole timeline.

        ``seed``: per-request sampling seed. The noise is counted off
        (class, request-local step, seed), so resubmitting the same
        (prime, seed, temperature) returns the same samples whatever the
        pool's load or the admission time, and equals a solo
        ``generate_fast_batched`` call with ``lane_seed=[seed]``. Defaults
        to a distinct per-request seed derived from the pool seed."""
        prime = np.atleast_1d(np.asarray(prime))
        if prime.ndim != 1 or prime.size < 1:
            raise ValueError("prime must be a 1-D class sequence")
        if not np.issubdtype(prime.dtype, np.integer):
            raise ValueError("prime must hold integer class ids")
        if prime.min() < 0 or prime.max() >= self.cfg.classes:
            raise ValueError(f"prime classes must lie in [0, "
                             f"{self.cfg.classes})")
        prime = prime.astype(np.int32)
        if num_samples < 1:
            raise ValueError("num_samples must be >= 1")
        cond = self._check_cond(prime.size - 1 + num_samples, cond,
                                cond_frames)
        h = GenerationHandle(num_samples, on_chunk)
        h._classes = self.cfg.classes
        h.timing["t_submit"] = time.perf_counter()
        with self._lifecycle:
            if self._closing or self._draining:
                raise RuntimeError("batcher is closed") from self._error
            if (self.max_pending is not None
                    and self._submit_q.qsize() >= self.max_pending):
                raise PoolOverloaded(
                    f"{self._submit_q.qsize()} requests already waiting "
                    f"(max_pending={self.max_pending})")
            if seed is None:  # distinct per request, derived from pool seed
                self._auto_seed = (
                    self._auto_seed * 2654435761 + 1) & 0xFFFFFFFF
                seed = self._auto_seed
            seed = int(seed) & 0xFFFFFFFF  # wrap into int32 range
            if seed >= 1 << 31:
                seed -= 1 << 32
            with self._count_lock:
                self._outstanding += 1
            h._on_done = self._request_done
            self._submit_q.put(_Pending(h, prime, float(temperature), seed,
                                        cond))
        self._wake.set()
        return h

    def _check_cond(self, total: int, cond, cond_frames):
        """The request's conditioning (rows or frames, f32), checked
        against the pool's mode and the timeline's ``total`` rows."""
        M = self.cfg.cond_channels
        if cond is not None and cond_frames is not None:
            raise ValueError("pass cond OR cond_frames, not both")
        if cond is not None:
            if self.cond_hop is not None:
                raise ValueError(
                    "this pool ships conditioning as frames "
                    f"(cond_hop={self.cond_hop}); pass cond_frames=")
            if M == 0:
                raise ValueError("cond given but cfg.cond_channels == 0")
            cond = np.asarray(cond, np.float32)
            if cond.shape != (total, M):
                raise ValueError(f"cond shape {cond.shape} != {(total, M)}")
            return cond
        if cond_frames is not None:
            if self.cond_hop is None:
                raise ValueError(
                    "cond_frames needs a pool constructed with cond_hop=")
            frames = np.asarray(cond_frames, np.float32)
            need = -(-total // self.cond_hop)
            if frames.ndim != 2 or frames.shape[1] != M \
                    or frames.shape[0] < need:
                raise ValueError(f"cond_frames shape {frames.shape} must be "
                                 f"(F >= {need}, {M})")
            return frames
        return None

    def update_params(self, params) -> threading.Event:
        """Swap the model weights at the next chunk boundary WITHOUT
        dropping streams. In-flight requests continue on the new weights
        from their next chunk (their ring history was computed by the old
        ones; for strictly-one-model rollouts, drain first). The tree must
        have the same structure, shapes and dtypes as the current one.
        Returns an event set once the pool has installed the weights (on a
        mesh: every rank has): every request admitted after it runs on
        them."""
        old, new = dict(_leaves(self.params)), dict(_leaves(params))
        if old.keys() != new.keys():
            raise ValueError(f"params tree mismatch: {sorted(new)} != "
                             f"{sorted(old)}")
        for name, a in old.items():
            b = new[name]
            if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
                raise ValueError(
                    f"leaf {name} mismatch: {tuple(b.shape)}/{b.dtype} vs "
                    f"expected {tuple(a.shape)}/{a.dtype} (same config "
                    f"required)")
        installed = threading.Event()
        with self._count_lock:  # vs the worker's take (lost-update race)
            if self._staged_params is not None:  # superseded: never installed
                self._staged_params[1].set()
            self._staged_params = (params, installed)
        self._wake.set()
        return installed

    def stats(self) -> dict:
        """Point-in-time pool metrics (safe from any thread): static shape
        (``lanes``, ``chunk``, ``light_chunk``), live gauges (``active``,
        ``free``, ``queued``, ``outstanding``, ``pool_clock``), lifetime
        counters (``admitted``, ``completed``, ``cancelled``, ``failed``,
        ``samples_out``, ``pool_steps``, ``prime_calls``, ``bytes_down``,
        ``bytes_up``) and the worker's phase seconds (``t_*``). On a mesh
        also ``mesh_ranks``, the bytes rank 0 sent its followers and took
        from them (``mesh_bytes_out``, ``mesh_bytes_in``; weights apart,
        ``mesh_params_bytes``), their sum a pool step
        (``mesh_bytes_per_step``), and ``t_gather``, rank 0's wait for its
        followers' replies. Served by the server's ``/stats``."""
        active = len(self._active)
        with self._count_lock:
            outstanding = self._outstanding
        out = {
            "lanes": self.lanes, "chunk": self.chunk,
            "light_chunk": self.light_chunk, "active": active,
            "free": self.lanes - active, "queued": self._submit_q.qsize(),
            "outstanding": outstanding,
            "pool_clock": self._global_t(), **self._n,
            **{k: round(v, 3) for k, v in self._t.items()},
        }
        if self._link is not None:
            out.update(self._link.stats(self._n["pool_steps"]))
        return out

    def prewarm(self, timeout: float = 600.0):
        """Build the kernel, install the weights and step the empty pool
        once, on the worker (on a mesh: on every rank), before traffic
        (the first request then pays none of it). The counters and phase
        times restart at zero."""
        done = threading.Event()
        box: dict = {}
        with self._lifecycle:
            if self._closing:
                raise RuntimeError("batcher is closed") from self._error
            self._prewarm_q.put((done, box))
        self._wake.set()
        deadline = time.monotonic() + timeout
        while not done.wait(0.5):
            if not self._thread.is_alive():
                raise RuntimeError("the batcher's worker stopped") \
                    from self._error
            if time.monotonic() > deadline:
                raise TimeoutError("prewarm did not finish")
        if "error" in box:
            raise box["error"]

    def close(self, drain: bool = False, timeout: float = 60.0):
        """Stop the pool. ``drain=False`` (default) abandons outstanding
        work: every active and queued handle gets a RuntimeError at the
        next chunk boundary. ``drain=True`` refuses new submissions but
        keeps stepping until every accepted request completes (or
        ``timeout`` seconds pass, after which the rest is abandoned). On a
        mesh the followers are then stopped (their loops return)."""
        if drain:
            with self._lifecycle:
                self._draining = True  # submit() now refuses
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                with self._count_lock:
                    if self._outstanding == 0:
                        break
                time.sleep(0.05)
        with self._lifecycle:
            self._closing = True
        self._wake.set()
        self._thread.join(timeout=60)
        # the flag flips under the lifecycle lock, so every submit either
        # raised or enqueued before this drain
        with self._lifecycle:
            while not self._submit_q.empty():
                self._submit_q.get().handle._finish(
                    RuntimeError("batcher closed"))
            while not self._prewarm_q.empty():
                done, box = self._prewarm_q.get()
                box["error"] = RuntimeError("batcher closed")
                done.set()

    # ------------------------------------------------------------- device

    def _request_done(self):
        with self._count_lock:
            self._outstanding -= 1

    def _lane_args(self):
        """This rank's block of the per-lane temperature, seed and clock
        rows on the device (the whole pool without a mesh; rank 0's block
        is the first)."""
        w = self._width
        return self._device_rows(self._temps[:w], self._seeds[:w],
                                 self._toffs[:w])

    def _prime_args(self, pends: list[_Pending]):
        """Equal-length requests as :meth:`_prime_block`'s arguments:
        primes ``(k, ng)``, temperatures, seeds and the conditioning of the
        prime's rows (or None)."""
        riders = [(i, _Active(None, 0, 0, p.cond)) for i, p in
                  enumerate(pends) if p.cond is not None]
        return (np.stack([p.prime for p in pends]),
                np.array([p.temperature for p in pends], np.float32),
                np.array([p.seed for p in pends], np.int32),
                self._cond_host(pends[0].prime.size, riders) if riders
                else None)

    def _by_owner(self, lanes) -> dict[int, list[tuple[int, int]]]:
        """``{data index: [(position in lanes, block column), ...]}`` of
        global ``lanes`` (one block, index 0, without a mesh)."""
        out: dict[int, list[tuple[int, int]]] = {}
        for i, lane in enumerate(lanes):
            d, col = divmod(lane, self._width)
            out.setdefault(d, []).append((i, col))
        return out

    def _gather(self, local, idx, parts, dtype, shape):
        """The pending host copy of a result ``shape`` that the ranks
        computed: this rank's ``local`` copy (at ``idx``; None when it has
        no part) and the followers' replies ``parts`` (``(reply, idx)``).
        Without followers' parts, ``local`` itself."""
        if not parts:
            return local
        return self._link.gather(local, idx, parts, dtype, shape)

    def _collect(self, replies):
        """Wait for the followers' ``replies`` (raises a failure)."""
        for rep in replies:
            self._link.collect(rep)

    def _admit_group(self, group: list[_Pending], lanes: list[int]):
        """Prime ``group`` (equal prime lengths) into ``lanes``: each lane's
        owner primes its requests in one kernel call and splices them into
        its block at this clock (the followers are sent theirs first).
        Returns the pending copy of the first samples, in group order."""
        clock = self._global_t()
        owners = self._by_owner(lanes)

        def work(items):  # (positions in group, block columns, prime args)
            return (torch.tensor([i for i, _ in items]),
                    [c for _, c in items],
                    self._prime_args([group[i] for i, _ in items]))

        parts = []
        for d, items in owners.items():
            if d > 0:
                idx, cols, args = work(items)
                parts.append((self._link.admit(d, clock, cols, *args), idx))
        local = idx = None
        if 0 in owners:
            idx, cols, args = work(owners[0])
            local = self._prime_into(cols, *args)
        return self._gather(local, idx, parts, torch.int32, (len(group),))

    # --------------------------------------------------------------- loop

    def _admit(self):
        batch: list[_Pending] = []
        while len(batch) < len(self._free) and not self._submit_q.empty():
            p = self._submit_q.get()
            if p.handle.cancelled():
                self._n["cancelled"] += 1
                p.handle._finish(RequestCancelled("request cancelled"))
            else:
                batch.append(p)
        if not batch:
            return
        self._ensure_state()
        by_len: dict[int, list[_Pending]] = {}
        for p in batch:
            by_len.setdefault(p.prime.size, []).append(p)
        for group in by_len.values():
            p0 = self._t["t_prime_dispatch"]
            s0 = self._t["t_splice"]
            # the JAX package's lane choice
            lanes = [self._free.pop() for _ in group]
            try:
                firsts = self._admit_group(group, lanes)
            except BaseException as e:  # surface to callers, keep serving
                self._free.extend(reversed(lanes))
                self._n["failed"] += len(group)
                for p in group:
                    p.handle._finish(e)
                continue
            # the local clock is deterministic: ng - 1 ingested + 1 generated
            t_local = group[0].prime.size
            self._n["admitted"] += len(group)
            prime_s = self._t["t_prime_dispatch"] - p0
            splice_s = self._t["t_splice"] - s0
            now = time.perf_counter()
            recs = []
            for i, (pend, lane) in enumerate(zip(group, lanes)):
                self._temps[lane] = pend.temperature
                self._seeds[lane] = pend.seed
                # rebase the lane's noise clock: request-local time = pool
                # time + toff, constant from admission on
                self._toffs[lane] = t_local - self._global_t()
                tm = pend.handle.timing
                tm["t_admitted"] = now
                tm["prime_s"] = prime_s
                tm["splice_s"] = splice_s
                tm["group"] = len(group)
                act = _Active(pend.handle, lane, pend.handle.num_samples - 1)
                if pend.cond is not None:
                    if self.cond_hop is not None:  # the whole timeline
                        act.cond, act.cond_off = pend.cond, pend.prime.size
                    else:  # the rows the prime did not consume
                        act.cond = pend.cond[pend.prime.size:]
                if act.remaining <= 0:
                    # single-sample request: the lane frees right away (its
                    # one sample is the prime's output); it completes when
                    # the first samples are delivered
                    self._temps[lane] = 0.0
                    self._free.append(lane)
                else:
                    self._active.append(act)
                recs.append((pend.handle, act, i))
            # first samples go to the host behind the prime; _run waits for
            # them after the next chunk is launched
            self._deferred.append((firsts, recs))

    def _deliver_firsts(self):
        """Wait for deferred admission outputs and deliver each new
        request's first sample. Runs after the worker has launched the next
        chunk, so the wait (for the prime, queued before that chunk) never
        idles the device.

        On any error every swapped-out handle is resolved before
        re-raising: a single-sample request's handle lives only in this
        list, and an unresolved one would block its caller forever. The
        splice has already mixed the failed prime into the shared ring, so
        the pool restart (_run -> _fail_all) is the right blast radius."""
        if not self._deferred:
            return
        t0 = time.perf_counter()
        batches, self._deferred = self._deferred, []
        try:
            for pending, recs in batches:
                firsts = self._wait(pending).astype(np.int32, copy=False)
                self._deliver_firsts_of(firsts, recs)
        except BaseException as e:
            for _pending, recs in batches:
                for handle, _act, _row in recs:
                    if not handle.done():
                        self._n["failed"] += 1
                        handle._finish(e)
            raise
        finally:
            self._t["t_prime_sync"] += time.perf_counter() - t0

    def _deliver_firsts_of(self, firsts: np.ndarray, recs):
        for handle, act, row in recs:
            if handle.done():  # failed or reaped since admission
                continue
            if handle.cancelled():
                if act.remaining > 0:
                    continue  # _reap_cancelled owns active lanes
                self._n["cancelled"] += 1
                handle._finish(RequestCancelled("request cancelled"))
                continue
            handle.timing["t_first"] = time.perf_counter()
            try:
                handle._deliver(np.asarray([firsts[row]], np.int32))
                self._n["samples_out"] += 1
            except BaseException as e:  # a caller's on_chunk raised:
                if act.remaining > 0:  # fail that request, keep serving
                    self._temps[act.lane] = 0.0
                    self._free.append(act.lane)
                    self._active = [a for a in self._active if a is not act]
                self._n["failed"] += 1
                handle._finish(e)
                continue
            if act.remaining <= 0:
                self._n["completed"] += 1
                handle._finish()

    def _reap_cancelled(self):
        """Drop cancelled requests at the chunk boundary, freeing their
        lanes (a disconnected streaming client must not hold a lane for the
        rest of its clip)."""
        still = []
        for act in self._active:
            if act.handle.cancelled():
                self._temps[act.lane] = 0.0
                self._free.append(act.lane)
                self._n["cancelled"] += 1
                act.handle._finish(RequestCancelled("request cancelled"))
            else:
                still.append(act)
        self._active = still

    def _fail_all(self, error: BaseException):
        """A device step failed: the shared state is suspect, so fail every
        rider and restart the pool from a fresh bootstrap (on a mesh: every
        rank, after ``RESET``). A follower found gone stops the pool
        before any handle resolves, so no caller sees it take work again."""
        if self._link is not None and self._link.broken is not None:
            self._stop(self._link.broken)
        # count only unresolved handles: _deliver_firsts already counted
        # and finished the riders it owned
        for act in self._active:
            if not act.handle.done():
                self._n["failed"] += 1
                act.handle._finish(error)
        self._active = []
        for _, recs in self._deferred:
            for handle, _act, _row in recs:
                if not handle.done():
                    self._n["failed"] += 1
                    handle._finish(error)
        self._deferred = []
        self._free = list(range(self.lanes))
        self._temps[:] = 0.0
        self._state = None
        self._dev_args = self._host_args = None
        if self._link is not None:
            try:
                self._link.reset()
            except BaseException as e:  # a follower is gone: stop the pool
                self._stop(e)
            self._w = None  # every rank installs rank 0's weights again

    def _pick_chunk(self) -> int:
        """Chunk width for the next dispatch: ``light_chunk`` while the pool
        is lightly loaded (low time to first audio), ``chunk`` under load
        (amortizes per-chunk overheads)."""
        if self.light_chunk is None:
            return self.chunk
        load = len(self._active) + self._submit_q.qsize()
        return (self.light_chunk
                if load <= self.light_threshold * self.lanes
                else self.chunk)

    def _dispatch_chunk(self):
        """Launch one pool step and start its copy to the host; returns
        ``(pending copy, riders, rows, n)`` WITHOUT waiting for the device,
        so the worker goes on to deliver the PREVIOUS chunk while this one
        runs. ``riders`` snapshots the active list as of this launch;
        ``rows`` maps a rider to its row when only the active lanes are
        copied (lightly loaded pools; None = rows are lanes); ``n`` is the
        chunk width. On a mesh each follower is sent the step first (its
        block's lane rows when they changed, its riders' conditioning), and
        the pending copy gathers every block's classes."""
        n = self._pick_chunk()
        self._n["pool_steps"] += 1
        riders = list(self._active)
        w = self._width
        conds: dict[int, list] = {}  # owner: [(block column, rider)]
        for a in riders:
            if a.cond is not None:
                d, col = divmod(a.lane, w)
                conds.setdefault(d, []).append((col, a))
        parts = []
        if self._link is not None:
            clock = self._global_t()
            for d in self._link.followers:
                blk = slice(d * w, (d + 1) * w)
                rows = (self._temps[blk], self._seeds[blk], self._toffs[blk])
                cond = self._cond_host(n, conds[d]) if d in conds else None
                parts.append((self._link.step(d, n, clock, rows, cond,
                                              self._wire_dtype()), blk))
        own = conds.get(0)
        cond = self._chunk_cond(w, n, own) if own else None
        cls = self._step_pool(n, *self._lane_args(), cond=cond)
        rows = None
        if self._link is None and riders and len(riders) * 2 <= self.lanes:
            # lightly loaded pool: copy only the active lanes' rows (free
            # lanes' greedy output is discarded anyway)
            sel = self._upload(np.asarray([a.lane for a in riders], np.int64))
            cls = cls.index_select(0, sel)
            rows = {id(a): i for i, a in enumerate(riders)}
        wire = cls.to(self._wire_dtype())
        self._n["bytes_down"] += wire.numel() * wire.element_size()
        pending = self._gather(self._download(wire), slice(0, w), parts,
                               wire.dtype, (self.lanes, n))
        return pending, riders, rows, n

    def _deliver_chunk(self, pending, riders, rows=None, n=None):
        """Wait for a dispatched chunk's copy and hand it to its riders. A
        rider that finished or was cancelled after the dispatch is skipped:
        its trailing samples are discarded, like a free lane's output."""
        if n is None:
            n = self.chunk
        cls = self._wait(pending).astype(np.int32)
        still = []
        rider_ids = {id(a) for a in riders}
        for act in self._active:
            if id(act) not in rider_ids:  # admitted after this dispatch
                still.append(act)
                continue
            take = min(act.remaining, n)
            row = act.lane if rows is None else rows[id(act)]
            try:
                act.handle._deliver(cls[row, :take])
                self._n["samples_out"] += take
            except BaseException as e:  # caller's on_chunk raised
                self._temps[act.lane] = 0.0
                self._free.append(act.lane)
                self._n["failed"] += 1
                act.handle._finish(e)
                continue
            act.remaining -= take
            if act.remaining <= 0:
                self._temps[act.lane] = 0.0
                self._free.append(act.lane)
                self._n["completed"] += 1
                act.handle._finish()
            else:
                still.append(act)
        self._active = still

    def _take_params(self):
        """Install the weights at first use and after update_params (on a
        mesh: on every rank, the event set once all have them)."""
        staged = None
        if self._staged_params is not None:
            with self._count_lock:  # atomic take: a reload racing this
                staged = self._staged_params  # window is never dropped
                self._staged_params = None
        if staged is not None:
            params = staged[0]
            self._installing.append(staged[1])
        elif self._w is None:
            params = self.params
        else:
            return
        # the followers take the leaves while this rank prepares its own
        replies = self._link.install(params) if self._link is not None else ()
        self._install_params(params)
        self._collect(replies)
        for ev in self._installing:
            ev.set()
        self._installing = []

    def _serve_prewarm(self):
        while not self._prewarm_q.empty():
            done, box = self._prewarm_q.get()
            try:
                self._take_params()
                replies = (self._link.prewarm() if self._link is not None
                           else ())
                self._prewarm_block()
                self._collect(replies)
                # warm-up work is not serving work
                self._n["prime_calls"] = 0
                self._n["pool_steps"] = 0
                for k in self._t:
                    self._t[k] = 0.0
                if self._link is not None:
                    self._link.clear_counts()
            except BaseException as e:
                box["error"] = e
                self._fail_all(e)
            finally:
                done.set()

    def _stop(self, error: BaseException):
        """The worker cannot go on: refuse all work, now and later."""
        with self._lifecycle:
            self._closing = True
            self._error = error
            while not self._submit_q.empty():
                self._submit_q.get().handle._finish(error)
            while not self._prewarm_q.empty():
                done, box = self._prewarm_q.get()
                box["error"] = error
                done.set()

    def _run(self):
        try:
            try:
                ctx = self._device_context()
            except BaseException as e:
                self._stop(e)
                return
            with ctx, torch.no_grad():
                self._loop()
        finally:
            if self._link is not None:
                self._link.stop()  # the followers' loops return

    def _loop(self):
        # Nothing may escape this loop while the pool is open: an exception
        # that killed the thread would leave every active and future handle
        # blocked forever. Per-request failures are handled inline; a
        # failed device step fails its riders and re-bootstraps the pool.
        # One chunk in flight: launch chunk i+1 BEFORE handing out chunk i,
        # so the host's per-chunk work (the copy, on_chunk callbacks, socket
        # writes) overlaps the next device step. Admissions happen between
        # the two, against the already-advanced state, and deliveries pair
        # each chunk with its launch-time rider snapshot.
        pending = None  # (copy, riders, rows, n) of the chunk in flight
        while not self._closing:
            try:
                if not self._active and self._submit_q.empty():
                    self._serve_prewarm()
                self._take_params()
                self._reap_cancelled()
                t0 = time.perf_counter()
                self._admit()
                t1 = time.perf_counter()
                self._t["t_admit"] += t1 - t0
                nxt = self._dispatch_chunk() if self._active else None
                t2 = time.perf_counter()
                self._t["t_dispatch"] += t2 - t1
                # wait for admission outputs only now: the next chunk is
                # already queued behind the prime
                self._deliver_firsts()
                t3 = time.perf_counter()
                if pending is not None:
                    self._deliver_chunk(*pending)
                    self._t["t_deliver"] += time.perf_counter() - t3
                pending = nxt
                if pending is None and not self._active:
                    t3 = time.perf_counter()
                    self._wake.wait(timeout=0.1)
                    self._wake.clear()
                    self._t["t_idle"] += time.perf_counter() - t3
                    if self._link is not None:
                        self._link.keepalive()
            except BaseException as e:
                pending = None
                self._fail_all(e)
        try:  # flush deferred first samples before the final chunk drain
            self._deliver_firsts()
        except BaseException as e:
            self._fail_all(e)
        if pending is not None:  # drain the in-flight chunk: its riders'
            try:  # final samples must not vanish on a graceful close
                self._deliver_chunk(*pending)
            except BaseException as e:
                self._fail_all(e)
        for act in self._active:
            act.handle._finish(RuntimeError("batcher closed"))
        while not self._submit_q.empty():
            self._submit_q.get().handle._finish(
                RuntimeError("batcher closed"))


def follow_pool(params: Params, cfg: WaveNetConfig, mesh, **pool_opts):
    """Run this rank's block of a pool on ``mesh`` until rank 0's
    :class:`ContinuousBatcher` closes it (the server and ``serving_bench``
    call it on every rank but 0). ``pool_opts`` are the batcher's keyword
    arguments, the same on every rank (the scheduling ones, ``seed``,
    ``max_pending``, ``light_chunk``, ``light_threshold``, are rank 0's).
    ``params`` give the weights' structure: rank 0 sends its own values at
    first use and at every ``update_params``. Returns the follower's
    counters; raises when rank 0 is gone."""
    import torch.distributed as dist

    from ._mesh_pool import _Follower

    f = _Follower(params, cfg, mesh, **pool_opts)
    if f._n_data < 2 or dist.get_rank() == 0:
        raise ValueError("follow_pool runs on every rank of a data mesh of "
                         "2 or more ranks but rank 0, whose "
                         "ContinuousBatcher(mesh=) schedules the pool")
    return f.run()
