"""The lane pool on a mesh: rank 0's link to its followers, and the
follower loop that every other rank runs (``serving/batcher.py``'s module
docstring has the design).

Messages go from rank 0 to one follower as a fixed header (op, chunk
width ``n``, the pool clock, the payload's bytes, a count, flags) and, when
the header says so, one payload: tensors packed back to back
(:func:`pack`). Every message gets exactly one reply, in order: an 8-byte
status and the op's result bytes, whose size both sides know from the
header (a step: the block's classes in the wire dtype; an admission: its
first samples). A follower that fails says so (its error text follows on
a tag of its own) and answers every later message with a failure until
``RESET``. Rank 0 posts each reply's receive when it sends the message and
waits for it where it needs it, so one chunk stays in flight. Every
transfer is a host tensor: gloo never sees a CUDA tensor.

  op        payload (rank 0 -> owner)                      reply
  STEP      block's lane rows if changed; riders' cond     classes (B, n)
  ADMIT     columns, primes (k, ng), temps, seeds; cond    firsts (k,)
  PARAMS    every leaf, in sorted path order               -
  PREWARM   -                                              -
  RESET     -                                              -
  PING      - (rank 0 is idle: a keepalive)                -
  STOP      -                                              -
"""

from __future__ import annotations

import time
from collections import deque
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import DATA_AXIS, axis_index, axis_ranks
from . import batcher
from .batcher import _LaneWork, _data_blocks, _leaves

STEP, ADMIT, PARAMS, PREWARM, RESET, PING, STOP = range(1, 8)
_NAMES = {STEP: "STEP", ADMIT: "ADMIT", PARAMS: "PARAMS",
          PREWARM: "PREWARM", RESET: "RESET", PING: "PING", STOP: "STOP"}
ROWS, COND = 1, 2  # header flags of a STEP (ADMIT: COND)
OK, ERROR, FAILED = 0, 1, 2  # reply status
TAG_MSG, TAG_PAYLOAD, TAG_REPLY, TAG_ERROR = 7101, 7102, 7103, 7104
HEADER = 6  # int64s: op, n, clock, payload bytes, count, flags

_DTYPES = (torch.float32, torch.int32, torch.int64, torch.bfloat16,
           torch.uint8, torch.int16)


def pack(tensors) -> torch.Tensor:
    """Host tensors (or numpy arrays) as one uint8 tensor: a table of
    dtypes and shapes, then each tensor's bytes padded to 8."""
    meta, raw = [len(tensors)], []
    for t in tensors:
        t = torch.as_tensor(t).detach().cpu().contiguous()
        meta += [_DTYPES.index(t.dtype), t.dim(), *t.shape]
        b = t.reshape(-1).view(torch.uint8)
        raw += [b, torch.zeros(-b.numel() % 8, dtype=torch.uint8)]
    head = torch.tensor([len(meta), *meta], dtype=torch.int64)
    return torch.cat([head.view(torch.uint8), *raw])


def unpack(buf: torch.Tensor) -> list[torch.Tensor]:
    m = int(buf[:8].view(torch.int64)[0])
    meta = buf[8:8 + 8 * m].view(torch.int64).tolist()
    off, i, out = 8 + 8 * m, 1, []
    for _ in range(meta[0]):
        dtype, nd = _DTYPES[meta[i]], meta[i + 1]
        shape = meta[i + 2:i + 2 + nd]
        i += 2 + nd
        size = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        out.append(buf[off:off + size].view(dtype).reshape(shape))
        off += size + (-size % 8)
    return out


def _wire_size(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


class FollowerError(RuntimeError):
    """A follower reported a failure (its riders fail, every rank
    re-bootstraps)."""


class _Reply:
    """One message's reply, in flight: its receive was posted with the
    send."""

    def __init__(self, d: int, rank: int, op: int, size: int):
        self.d, self.rank, self.op = d, rank, op
        self.buf = torch.empty(8 + size, dtype=torch.uint8)
        self.work = dist.irecv(self.buf, rank, tag=TAG_REPLY)
        self.status = None
        self.text = ""

    def result(self) -> torch.Tensor:
        if self.status == OK:
            return self.buf[8:]
        if self.status == ERROR:
            raise FollowerError(f"pool rank {self.rank} failed at "
                                f"{_NAMES[self.op]}: {self.text}")
        raise FollowerError(f"pool rank {self.rank} failed earlier and "
                            f"waits for RESET")


class _Gathered:
    """The ``event`` half of a pending host copy whose tensor takes rank
    0's own part and every follower's reply: ``synchronize()`` fills it."""

    def __init__(self, link, host, local, parts):
        self.link, self.host = link, host
        self.local = local  # ((host part, event), index) or None
        self.parts = parts  # [(reply, index)]

    def synchronize(self):
        if self.local is not None:
            (part, ev), idx = self.local
            if ev is not None:
                ev.synchronize()
            self.host[idx] = part
        t0 = time.perf_counter()
        try:
            for rep, idx in self.parts:
                self.host[idx] = self.link.collect(rep).view(
                    self.host.dtype).reshape(self.host[idx].shape)
        finally:
            self.link.t_wait += time.perf_counter() - t0


class Followers:
    """Rank 0's side of the mesh: one message stream to each follower
    (data index d on global rank ``ranks[d]``, lanes ``[d B, (d + 1) B)``)
    and the replies in flight. It only carries messages: the batcher does
    its own block's work and merges the replies (:meth:`gather`)."""

    def __init__(self, mesh, width: int):
        if dist.get_rank() != 0 or axis_index(mesh, DATA_AXIS) != 0:
            raise ValueError("ContinuousBatcher(mesh=) schedules the pool "
                             "from global rank 0 (data index 0); every "
                             "other rank calls follow_pool")
        self.ranks = axis_ranks(mesh, DATA_AXIS)
        self.width = width
        self.timeout = timedelta(seconds=batcher.MESH_TIMEOUT)
        self.heartbeat = batcher.MESH_TIMEOUT / 4
        self.followers = range(1, len(self.ranks))
        self._replies = {d: deque() for d in self.followers}
        self._sends: list = []
        self.last_rows: dict = {d: None for d in self.followers}
        self.dead: set[int] = set()
        self.broken: BaseException | None = None
        self.last_sent = time.monotonic()
        self.clear_counts()

    def clear_counts(self):
        self.bytes_out = self.bytes_in = self.bytes_params = 0
        self.bytes_step = self.bytes_admit = 0
        self.t_wait = 0.0

    def stats(self, steps: int) -> dict:
        return {"mesh_ranks": len(self.ranks),
                "mesh_bytes_out": self.bytes_out,
                "mesh_bytes_in": self.bytes_in,
                "mesh_params_bytes": self.bytes_params,
                "mesh_step_bytes": self.bytes_step,
                "mesh_admit_bytes": self.bytes_admit,
                "mesh_bytes_per_step": (round(self.bytes_step / steps)
                                        if steps else 0),
                "t_gather": round(self.t_wait, 3)}

    # ---------------------------------------------------------- transport

    def _broke(self, d: int, e: Exception):
        self.dead.add(d)
        self.broken = RuntimeError(
            f"the pool's rank {self.ranks[d]} is gone or silent (waited up "
            f"to {self.timeout.total_seconds():g} s): {e}")
        raise self.broken from e

    def send(self, d: int, op: int, n: int = 0, clock: int = 0, k: int = 0,
             flags: int = 0, tensors=(), reply: int = 0) -> _Reply:
        """Send ``op`` to data index ``d`` and post its reply's receive
        (``reply`` result bytes)."""
        if self.broken is not None:
            raise self.broken
        payload = pack(tensors) if len(tensors) else None
        nbytes = 0 if payload is None else payload.numel()
        header = torch.tensor([op, n, clock, nbytes, k, flags],
                              dtype=torch.int64)
        rank = self.ranks[d]
        try:
            rep = _Reply(d, rank, op, reply)
            self._sends.append((dist.isend(header, rank, tag=TAG_MSG),
                                header))
            if payload is not None:
                self._sends.append((dist.isend(payload, rank,
                                               tag=TAG_PAYLOAD), payload))
        except Exception as e:
            self._broke(d, e)
        self._replies[d].append(rep)
        sent = 8 * HEADER + nbytes
        if op == PARAMS:
            self.bytes_params += nbytes
            sent = 8 * HEADER
        self.bytes_out += sent
        # a step's (an admission's) traffic both ways, its reply's size
        # fixed by the message: counted whole when it is sent
        if op == STEP:
            self.bytes_step += sent + 8 + reply
        elif op == ADMIT:
            self.bytes_admit += sent + 8 + reply
        self.last_sent = time.monotonic()
        self._prune()
        return rep

    def _prune(self):
        """Drop finished sends (a send and its tensor stay referenced until
        the transfer is done)."""
        self._sends = [s for s in self._sends if not s[0].is_completed()]

    def _finish(self, rep: _Reply):
        """Wait for the oldest reply of its follower and read its status
        (and a failure's text)."""
        try:
            if not rep.work.wait(self.timeout):
                raise TimeoutError("no reply")
            rep.status = int(rep.buf[:8].view(torch.int64)[0])
            if rep.status == ERROR:
                size = torch.empty(1, dtype=torch.int64)
                if not dist.irecv(size, rep.rank, tag=TAG_ERROR).wait(
                        self.timeout):
                    raise TimeoutError("no error text")
                text = torch.empty(int(size[0]), dtype=torch.uint8)
                if not dist.irecv(text, rep.rank, tag=TAG_ERROR).wait(
                        self.timeout):
                    raise TimeoutError("no error text")
                rep.text = bytes(text.numpy()).decode(errors="replace")
                self.bytes_in += 8 + text.numel()
        except Exception as e:
            self._broke(rep.d, e)
        self.bytes_in += rep.buf.numel()

    def collect(self, rep: _Reply) -> torch.Tensor:
        """``rep``'s result bytes, after the follower's earlier replies
        (read in order); raises :class:`FollowerError` for a failure the
        follower reported."""
        q = self._replies[rep.d]
        while rep.status is None:
            if self.broken is not None:
                raise self.broken
            self._finish(q.popleft())
        return rep.result()

    def _drain(self, d: int):
        """Read every reply of ``d`` still in flight, failures included."""
        q = self._replies[d]
        while q:
            if self.broken is not None:
                raise self.broken
            self._finish(q.popleft())

    # ------------------------------------------------------------ the ops

    def _each(self, op: int, tensors=()) -> list[_Reply]:
        """Send ``op`` to every follower; returns the replies in flight."""
        return [self.send(d, op, tensors=tensors) for d in self.followers]

    def install(self, params) -> list[_Reply]:
        """Send every follower the weights ``params`` (every leaf)."""
        return self._each(PARAMS, [v.detach().to("cpu")
                                   for _, v in _leaves(params)])

    def prewarm(self) -> list[_Reply]:
        return self._each(PREWARM)

    def reset(self):
        """After a failure: read every reply in flight, then every rank
        drops its block's state and weights (re-bootstrapped at the next
        admission, rank 0's weights sent again)."""
        if self.broken is not None:
            raise self.broken
        for d in self.followers:
            self._drain(d)
        for rep in self._each(RESET):
            self.collect(rep)
        self.last_rows = {d: None for d in self.followers}

    def keepalive(self):
        """While rank 0 idles: a PING every ``timeout / 4`` seconds, so a
        follower that waits for the next message never times out (and a
        follower that died shows)."""
        if time.monotonic() - self.last_sent >= self.heartbeat:
            for rep in self._each(PING):
                self.collect(rep)

    def stop(self):
        """End the loop of every follower that still answers (best effort:
        a follower found gone is skipped)."""
        broken, self.broken = self.broken, None
        for d in self.followers:
            if d in self.dead:
                continue
            try:
                self._drain(d)
                self.collect(self.send(d, STOP))
            except Exception:
                self.broken = None  # d is marked dead: go on with the rest
        for work, _ in self._sends:
            try:
                work.wait(self.timeout)
            except Exception:
                pass  # a send to a follower found gone
        self._sends = []
        self.broken = broken or self.broken

    def admit(self, d: int, clock: int, cols, primes, temps, seeds,
              cond=None) -> _Reply:
        """Send data index ``d`` an admission at the pool clock ``clock``:
        block columns ``cols``, primes ``(k, ng)``, temperatures, seeds and
        the prime rows' conditioning (the batcher's ``_cond_host`` parts,
        or None). The owner primes and splices them; its reply is their
        first samples (int32)."""
        k, ng = primes.shape
        tensors = [np.asarray(cols, np.int64), primes, temps, seeds]
        if cond is not None:
            tensors += [cond[0], *cond[1]]
        return self.send(d, ADMIT, n=ng, clock=clock, k=k,
                         flags=0 if cond is None else COND, tensors=tensors,
                         reply=4 * k)

    def step(self, d: int, n: int, clock: int, rows, cond, wire) -> _Reply:
        """Send data index ``d`` one pool step of ``n`` at ``clock``: its
        block's lane rows ``(temps, seeds, toffs)`` when they changed since
        the last step sent, and its riders' conditioning (the batcher's
        ``_cond_host`` parts, or None). Its reply is the block's classes
        ``(B, n)`` in the wire dtype ``wire``."""
        tensors, flags = [], 0
        last = self.last_rows[d]
        if last is None or not all(np.array_equal(a, b)
                                   for a, b in zip(rows, last)):
            self.last_rows[d] = tuple(a.copy() for a in rows)
            tensors += list(self.last_rows[d])
            flags |= ROWS
        if cond is not None:
            tensors += [cond[0], *cond[1]]
            flags |= COND
        return self.send(d, STEP, n=n, clock=clock, flags=flags,
                         tensors=tensors,
                         reply=self.width * n * _wire_size(wire))

    def gather(self, local, idx, parts, dtype, shape):
        """A pending host copy ``(host tensor, event)`` of ``shape``:
        ``local`` (rank 0's pending copy, or None) lands at ``idx`` and
        each reply of ``parts`` (``(reply, idx)``) at its own, when the
        event's ``synchronize()`` runs."""
        host = torch.empty(shape, dtype=dtype)
        return host, _Gathered(self, host, None if local is None
                               else (local, idx), parts)


class _Follower(_LaneWork):
    """A follower's block of the pool: rank 0's messages in, one reply
    each out."""

    def __init__(self, params, cfg, mesh, *, lanes: int = 128,
                 chunk: int = 128, seed: int = 0, fuse_res: bool = False,
                 skip_slab: bool = False, regularize: float = 0.0,
                 max_pending=None, light_chunk=None,
                 light_threshold: float = 0.25, cond_hop=None,
                 cond_wire_dtype=torch.float32, ring_dtype=torch.float32,
                 device="cuda"):
        self._configure(params, cfg, lanes, chunk, light_chunk, cond_hop,
                        cond_wire_dtype, ring_dtype, device, fuse_res,
                        skip_slab, regularize)
        self._n_data, self._width = _data_blocks(mesh, lanes)
        self.timeout = timedelta(seconds=batcher.MESH_TIMEOUT)
        self._n = dict(prime_calls=0, pool_steps=0, headless_steps=0,
                       bytes_up=0, wide_launches=0)
        self._t = dict(t_prime_dispatch=0.0, t_splice=0.0)
        self._rows = self._zero_rows()
        self._failed = False
        self._sends: list = []

    def _zero_rows(self):
        w = self._width
        return (np.zeros(w, np.float32), np.zeros(w, np.int32),
                np.zeros(w, np.int32))

    def _lane_args(self):
        return self._device_rows(*self._rows)

    def _check_clock(self, clock: int):
        self._ensure_state()
        if self._clock != clock:
            raise RuntimeError(f"clock {self._clock} != rank 0's {clock}")

    # ---------------------------------------------------------------- ops

    def _weights(self, tensors):
        it = iter(tensors)
        tree = {}
        for path, like in _leaves(self.params):
            v = next(it)
            if tuple(v.shape) != tuple(like.shape) or v.dtype != like.dtype:
                raise ValueError(f"leaf {path}: {tuple(v.shape)}/{v.dtype}, "
                                 f"expected {tuple(like.shape)}/{like.dtype}")
            node = tree
            keys = path.strip("/").split("/")
            for key in keys[:-1]:
                node = node.setdefault(key, {})
            node[keys[-1]] = v.clone()
        self._install_params(tree)

    def _admit(self, t, n, clock, flags):
        cols, primes, temps, seeds = (x.numpy() for x in t[:4])
        cond = None
        if flags & COND:
            cond = self._cond_parts(t[4:])
        if self._w is None:
            raise RuntimeError("no weights installed")
        self._check_clock(clock)
        return self._wait(self._prime_into(cols.tolist(), primes, temps,
                                           seeds, cond))

    def _cond_parts(self, t):
        """:meth:`_cond_host`'s parts as they arrive: rows, or frames."""
        if self.cond_hop is None:
            return t[0].numpy(), (t[1].numpy(),)
        return t[0].numpy(), (t[1], t[2].numpy())

    def _step_block(self, t, n, clock, flags):
        if flags & ROWS:
            self._rows = tuple(x.numpy().copy() for x in t[:3])
            t = t[3:]
        if self._w is None:
            raise RuntimeError("no weights installed")
        self._check_clock(clock)
        cond = None
        if flags & COND:
            cond = self._cond_device(self._width, n, *self._cond_parts(t))
        cls = self._step_pool(n, *self._lane_args(), cond=cond)
        self._n["pool_steps"] += 1
        return self._wait(self._download(cls.to(self._wire_dtype())))

    def _reset(self):
        self._state = None
        self._w = None
        self._dev_args = self._host_args = None
        self._rows = self._zero_rows()
        self._failed = False

    # --------------------------------------------------------------- loop

    def _recv(self, shape, dtype, tag):
        buf = torch.empty(shape, dtype=dtype)
        if not dist.irecv(buf, 0, tag=tag).wait(self.timeout):
            raise TimeoutError("rank 0 sent nothing")
        return buf

    def _reply(self, status: int, body: np.ndarray | None, size: int,
               text: str = ""):
        out = torch.zeros(8 + size, dtype=torch.uint8)
        out[:8] = torch.tensor([status], dtype=torch.int64).view(torch.uint8)
        if body is not None and status == OK:
            out[8:] = torch.frombuffer(bytearray(body.tobytes()),
                                       dtype=torch.uint8)
        for work, _ in self._sends:
            work.wait(self.timeout)
        self._sends = [(dist.isend(out, 0, tag=TAG_REPLY), out)]
        if status == ERROR:
            raw = torch.frombuffer(bytearray(text.encode()),
                                   dtype=torch.uint8)
            size_t = torch.tensor([raw.numel()], dtype=torch.int64)
            dist.send(size_t, 0, tag=TAG_ERROR)
            dist.send(raw, 0, tag=TAG_ERROR)

    def run(self) -> dict:
        """Serve rank 0's messages until ``STOP``."""
        wire = _wire_size(self._wire_dtype())
        with self._device_context(), torch.no_grad():
            while True:
                op, n, clock, nbytes, k, flags = self._recv(
                    HEADER, torch.int64, TAG_MSG).tolist()
                t = (unpack(self._recv(nbytes, torch.uint8, TAG_PAYLOAD))
                     if nbytes else [])
                size = {STEP: self._width * n * wire, ADMIT: 4 * k}.get(op, 0)
                if op == STOP:
                    self._reply(OK, None, 0)
                    break
                if self._failed and op not in (RESET, PING):
                    self._reply(FAILED, None, size)
                    continue
                try:
                    body = None
                    if op == STEP:
                        body = self._step_block(t, n, clock, flags)
                    elif op == ADMIT:
                        body = self._admit(t, n, clock, flags)
                    elif op == PARAMS:
                        self._weights(t)
                    elif op == PREWARM:
                        self._prewarm_block()
                    elif op == RESET:
                        self._reset()
                    elif op != PING:
                        raise ValueError(f"unknown op {op}")
                except Exception as e:  # reported to rank 0, then RESET
                    self._failed = True
                    self._reply(ERROR, None, size, f"{type(e).__name__}: {e}")
                    continue
                self._reply(OK, body, size)
        for work, _ in self._sends:
            work.wait(self.timeout)
        return dict(self._n)

