"""Streaming synthesis server: WaveNet generation over HTTP.

The serving paths of the JAX package's ``scripts/serve.py``:

* single stream (default): audio is generated in chunks by the fused
  generation kernel (K1), the ring state (``FusedGenState``) flows from one
  chunk to the next, and each chunk's PCM goes to the client as soon as it
  exists. Concurrent requests take turns chunk by chunk on one lock.
* ``--batcher``: concurrent requests share one persistent multi-stream
  rollout (``serving/batcher.py``, the batched kernel K4): each request
  takes a lane of a ``--lanes`` pool, joins at the next chunk boundary and
  streams out chunk by chunk; a client that hangs up frees its lane. The
  pool runs ``fuse_res``, and ``skip_slab`` when the model's skip width is
  256 or more. ``--max-pending`` answers 503 beyond that queue depth.
  ``--bf16-rings`` stores the pool's ring in bf16 (half its bytes; a
  response then equals its solo rollout with bf16 rings).
* ``--batcher --mesh-data N`` under ``torch.distributed.run`` with N
  ranks: the pool's ``--lanes`` (its total) split into N blocks, one a
  rank. Rank 0 serves HTTP and schedules the pool
  (``ContinuousBatcher(mesh=)``); every other rank runs its block
  (``serving.batcher.follow_pool``) until rank 0 stops, then exits. Each
  response is bitwise the one a single process gives. Stop the server
  with SIGINT to rank 0 (its pid is printed); every rank then prints its
  K4 launches. A launch of more than one rank without ``--batcher`` is
  refused: only the pool spans ranks.

``--reload-interval N`` follows a training run: every N seconds the newest
checkpoint under ``--snapshot-path`` is rolled in when it changed (its EMA
weights with ``--reload-ema``); a failed reload is printed and the old
weights keep serving.

``--ema`` serves the exponential moving average of the weights that a
snapshot trained with ``--ema-decay`` carries in its optimizer state
(written by either package), on either path.

``--torch-snapshot`` serves a reference (pytorch-wavenet) snapshot, a
whole-module pickle or a bare state dict (``--torch-layers``/
``--torch-blocks`` give a bare one's split), converted on load
(``models.convert.load_reference_snapshot``).

``--backend``: ``auto`` serves single streams through K1 on the card and
through its plain version on the CPU; ``plain`` serves
``models.generate.generate_fast`` (plain PyTorch, one ``gen_step`` a
sample, a ``torch.Generator`` seeded by the request) on either device, the
one way the plain path runs on the card. With ``--batcher`` the pool is
K4, and ``plain`` is refused.

``--student-snapshot`` serves a distilled IAF student
(``training.distill_cli``, either package's snapshot; backend
``iaf-student``): a clip is one parallel pass (``models/iaf.py``), with no
autoregression. ``/synthesize`` draws the clip's length rounded up to a
bucket of 8192 samples and cuts it, so a response is a prefix of its
bucket's draw for one seed; ``/vocode`` on a conditioned student is
``student_synthesize`` over the uploaded wav's mel frames. The student has
no history to prime (``prime``/``prime_audio`` answer 400) and no
temperature; ``--batcher`` and ``--ema`` are refused with it.

Endpoints
  GET  /health       -> JSON {status, backend, receptive_field,
                        parameter_count, classes (None for a student),
                        sample_rate}
  GET  /stats        -> JSON {backend} plus, with --batcher, the pool's
                        gauges and counters (ContinuousBatcher.stats)
  GET  /synthesize   -> audio/wav, streamed while it generates; query
                        params num_samples (16000), temperature (1.0),
                        seed (0), chunk (2048)
  POST /synthesize   -> the same, parameters as a JSON body, plus "prime"
                        (mu-law class ids) or "prime_audio" (float samples
                        in [-1, 1]), cut to the last receptive_field samples
  POST /reload       -> rolling weight update: the weights of a snapshot
                        (body {"snapshot": path, "ema": bool}; default the
                        newest under --snapshot-path) replace the served
                        ones at the next chunk, streams keep flowing; the
                        config must be the served one (400 otherwise;
                        503 when the pool does not take the weights)
                        -> JSON {reloaded, step}
  POST /profile      -> a torch.profiler capture of the live server into
                        --profile-dir (a Chrome trace JSON, CUDA kernels
                        included; under --mesh-data, rank 0's process
                        only), query seconds (3; clamped to [0.1, 60]);
                        one capture at a time (409 during one), 400
                        without --profile-dir; requests keep being served
  POST /vocode       -> audio/wav: copy-synthesis of the uploaded wav on a
                        conditioned model (400 on an unconditional one):
                        its log-mel frames drive a conditioned rollout of
                        F * hop samples; query params hop_length (256),
                        n_fft (1024), temperature (1.0), seed (0). Single
                        stream through K1 (``synthesize``); with --batcher
                        the request rides the pool as mel frames at the
                        pool's --cond-hop (503 when the pool is full)

A request's seed keys its sampling noise for every chunk, so a response
does not depend on the chunk size at any temperature; with --batcher it
does not depend on the pool's load either (the request's ``chunk`` is
ignored there: the pool's chunk rules).

Run:
  python -m pytorch_wavenet_tpu_torch.serving.server --snapshot model.ckpt --port 8765
  python -m pytorch_wavenet_tpu_torch.serving.server --snapshot model.ckpt --batcher --lanes 256 --batch-chunk 2048
  python -m torch.distributed.run --standalone --nproc-per-node 2 -m pytorch_wavenet_tpu_torch.serving.server --snapshot model.ckpt --batcher --lanes 256 --batch-chunk 2048 --mesh-data 2
  python -m pytorch_wavenet_tpu_torch.serving.server --snapshot model.ckpt --ema
  python -m pytorch_wavenet_tpu_torch.serving.server --student-snapshot student.ckpt
  python -m pytorch_wavenet_tpu_torch.serving.server --torch-snapshot ref_model.pt
  python -m pytorch_wavenet_tpu_torch.serving.server --snapshot-path snaps --batcher --reload-interval 30 --profile-dir profiles
  curl -s -X POST -d '{"snapshot": "snaps/m_0000002000.ckpt"}' localhost:8765/reload
  curl -s -X POST 'localhost:8765/profile?seconds=2'
  curl -sN 'localhost:8765/synthesize?num_samples=16000&temperature=0.9' > x.wav
  curl -s --data-binary @in.wav 'localhost:8765/vocode?seed=1' > out.wav
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import queue
import struct
import sys
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..data.audio_io import load_audio
from ..device import resolve_device
from ..models.convert import from_jax_params, load_reference_snapshot
from ..models.generate import generate_fast, synthesize
from ..models.iaf import (load_student_snapshot, student_generate,
                          student_parameter_count, student_synthesize)
from ..models.wavenet import params_to
from ..ops.cuda.gen_kernel import generate_fast_fused
from ..ops.mel import log_mel_spectrogram
from ..ops.mulaw import dequantize_to_f32, quantize_data
from ..training.optimizers import find_ema_state_dict
from ..utils import profiling
from ..utils.checkpoints import (latest_checkpoint, load_checkpoint,
                                 load_latest_model_from)
from .batcher import (MESH_TIMEOUT, ContinuousBatcher, PoolOverloaded,
                      follow_pool)


# a student's clip length rounds up to this many samples, so that clips of
# nearby lengths share one draw shape (the JAX package's jit buckets)
_STUDENT_BUCKET = 8192


def wav_header(num_samples: int, sr: int) -> bytes:
    """44-byte RIFF/WAVE header for 16-bit mono PCM of a known length,
    written first so that clients can play the stream as it arrives."""
    data_bytes = num_samples * 2
    return (
        b"RIFF" + struct.pack("<I", 36 + data_bytes) + b"WAVE"
        + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
        + b"data" + struct.pack("<I", data_bytes)
    )


BACKENDS = ("auto", "plain")
RELOAD_TIMEOUT_S = 600.0  # for the pool to take reloaded weights


class Synthesizer:
    """Owns the model on one device and runs rollouts chunk by chunk
    through the fused generation kernel, or, with ``batcher_opts``
    (:class:`ContinuousBatcher` keyword arguments), splices concurrent
    requests into one pooled rollout of the batched kernel (the plain
    versions on the CPU). With ``student``, ``cfg`` is an ``IAFConfig`` and
    every clip is one parallel pass of the student (backend
    ``iaf-student``).

    ``backend`` (single stream): ``auto`` (K1 on the card, its plain
    version on the CPU: ``cuda-fused``, ``cpu-plain``) or ``plain``
    (``models.generate.generate_fast`` on either device: ``cuda-plain``,
    ``cpu-plain``). The pool is K4, so only ``auto`` goes with
    ``batcher_opts``."""

    def __init__(self, params, cfg, sr: int = 16000,
                 device: str | torch.device = "cuda",
                 batcher_opts: dict | None = None, student: bool = False,
                 backend: str = "auto"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.sr = sr
        self.lock = threading.Lock()
        self.batcher = None
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, not "
                             f"{backend!r}")
        if backend != "auto" and batcher_opts is not None:
            raise ValueError("backend chooses the single-stream path; the "
                             "batcher's pool is the kernel K4")
        self.plain = backend == "plain"
        if student:
            self.params = params_to(params, self.device)
            self.backend = "iaf-student"
        elif batcher_opts is not None:
            self.params = params
            self.batcher = ContinuousBatcher(params, cfg, device=self.device,
                                             **batcher_opts)
            self.batcher.prewarm()
            self.backend = f"{self.device.type}-batcher"
        else:
            self.params = params_to(params, self.device)
            self.backend = ("cuda-fused" if self.device.type == "cuda"
                            and not self.plain
                            else f"{self.device.type}-plain")

    def parameter_count(self) -> int:
        if self.backend == "iaf-student":
            return student_parameter_count(self.params)
        return self.cfg.parameter_count()

    @staticmethod
    def bucket(n: int) -> int:
        """A student clip's draw length: ``n`` rounded up to the bucket."""
        return -(-n // _STUDENT_BUCKET) * _STUDENT_BUCKET

    def close(self):
        """Finish the pool's accepted requests, then stop it."""
        if self.batcher is not None:
            self.batcher.close(drain=True)

    def _stream_batched(self, num_samples: int, temperature: float,
                        seed: int, prime=None):
        """Bridge the batcher's chunk callbacks into a generator: the
        request joins the shared rollout at the next chunk boundary and wav
        chunks flow out as the pool produces them. The request's seed
        drives its own lane's noise counters, so the response does not
        depend on the pool's load. If the consumer abandons the stream
        (client hang-up), the request is cancelled and its lane frees at
        the next chunk boundary. Raises :class:`PoolOverloaded` at the
        first ``next`` when the pool's queue is full."""
        chunks: queue.Queue = queue.Queue()
        if prime is None:
            prime = np.asarray([self.cfg.classes // 2], np.int32)
        handle = self.batcher.submit(
            np.asarray(prime, np.int32), num_samples,
            temperature=temperature, on_chunk=chunks.put, seed=seed)
        got = 0
        try:
            while got < num_samples:
                try:
                    cls = chunks.get(timeout=1.0)
                except queue.Empty:
                    if not handle.done():
                        continue
                    # the last chunks can land between the timeout and the
                    # done() check: drain before giving up
                    try:
                        cls = chunks.get_nowait()
                    except queue.Empty:
                        handle.result(timeout=0)  # re-raise a batcher error
                        break
                cls = cls[: num_samples - got]
                got += cls.size
                yield dequantize_to_f32(cls, self.cfg.classes)
        finally:
            handle.cancel()  # no-op if complete; frees the lane otherwise

    @staticmethod
    def kernel_seed(seed: int) -> int:
        """The fused kernel's noise seed for a request's ``seed``."""
        return int(torch.randint(
            0, 2**31 - 1, (1,), generator=torch.Generator().manual_seed(seed)))

    def _single_stream(self, seed: int):
        """The single-stream rollout function, its noise for a request's
        ``seed`` and its keyword arguments: K1 (or its plain version on the
        CPU) with ``fuse_res``, or under ``plain`` ``generate_fast`` with a
        generator seeded by ``seed`` (carried across the chunks)."""
        if self.plain:
            return generate_fast, torch.Generator().manual_seed(seed), {}
        return generate_fast_fused, self.kernel_seed(seed), {"fuse_res": True}

    def reload(self, snapshot: str | None, snapshot_path: str,
               ema: bool = False) -> int:
        """Swap in the weights of ``snapshot`` (the newest checkpoint under
        ``snapshot_path`` when None; its EMA weights under ``ema``) without
        dropping streams: the pool takes them at its next chunk boundary
        (``ContinuousBatcher.update_params``), a single stream at its next
        chunk (the weights change under :attr:`lock`). Raises
        ``ValueError`` for a student, a snapshot that is not a path string,
        missing EMA weights or a config other than the served one, and
        ``RuntimeError`` when the pool has not taken the weights within
        :data:`RELOAD_TIMEOUT_S`; returns the snapshot's step."""
        if self.backend == "iaf-student":
            raise ValueError("reload serves WaveNet snapshots")
        if snapshot is not None and not isinstance(snapshot, str):
            # a JSON integer would reach open() as a file descriptor
            raise ValueError("snapshot must be a path string")
        blob = (load_checkpoint(snapshot, self.device) if snapshot
                else load_latest_model_from(snapshot_path, self.device))
        params = blob["params"]
        if ema:
            found = find_ema_state_dict(blob["opt_state"])
            if found is None:
                raise ValueError("snapshot carries no EMA weights")
            params = from_jax_params(found, self.device)
        if blob["config"] is not None and blob["config"] != self.cfg:
            raise ValueError("snapshot config differs from the serving "
                             "config")
        if self.batcher is not None:
            # the response waits for the pool to take them, so a request
            # that follows it runs on the new weights
            if not self.batcher.update_params(params).wait(
                    timeout=RELOAD_TIMEOUT_S):
                raise RuntimeError("the pool did not take the new weights")
        else:
            with self.lock:
                self.params = params
        return blob["step"]

    def mel_of(self, wav_bytes: bytes, hop_length: int,
               n_fft: int) -> np.ndarray:
        """Log-mel frames ``(F, cond_channels)`` of an uploaded wav,
        resampled to the server's rate."""
        fd, path = tempfile.mkstemp(suffix=".wav")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(wav_bytes)
            wav, sr = load_audio(path, sampling_rate=self.sr)
        finally:
            os.unlink(path)
        return log_mel_spectrogram(wav, num_mels=self.cfg.cond_channels,
                                   n_fft=n_fft, hop_length=hop_length,
                                   sampling_rate=sr)

    def vocode(self, wav_bytes: bytes, hop_length: int, n_fft: int,
               temperature: float, seed: int,
               max_samples: int | None = None) -> np.ndarray:
        """Copy-synthesis: wav bytes -> log-mel frames -> a conditioned
        rollout of ``F * hop`` samples (one mid-class prime sample);
        ``ValueError`` when that exceeds ``max_samples``.
        Single stream: ``models.generate.synthesize`` on the fused kernel
        (fuse_res; ``generate_fast`` under ``plain``); with the batcher,
        the frames ride the pool (``cond_frames``) and the request's seed
        keys its lane's noise.
        Returns float32 ``(F * hop,)``."""
        mel = self.mel_of(wav_bytes, hop_length, n_fft)
        n = mel.shape[0] * hop_length
        if max_samples is not None and n > max_samples:
            raise ValueError(f"the upload makes {n} samples, more than the "
                             f"server's {max_samples}")
        if self.backend == "iaf-student":
            # the whole clip in one parallel pass at the bucket's length;
            # rows past the last frame repeat it
            with self.lock:
                wav = student_synthesize(
                    self.params, self.cfg,
                    torch.Generator().manual_seed(seed), mel[None],
                    hop_length, num_samples=self.bucket(n),
                    device=self.device)
                return wav[0, :n].cpu().numpy()
        if self.batcher is not None:
            if self.batcher.cond_hop != hop_length:
                raise ValueError(
                    f"this pool expands conditioning at hop "
                    f"{self.batcher.cond_hop}; request used hop_length="
                    f"{hop_length}")
            h = self.batcher.submit(
                np.asarray([self.cfg.classes // 2], np.int32), n,
                temperature=temperature, cond_frames=mel, seed=seed)
            wav, _ = h.result(timeout=3600)
            return wav
        fn, noise, kw = self._single_stream(seed)
        with self.lock:
            wav, _ = synthesize(
                self.params, self.cfg, noise, mel, hop_length,
                temperature=temperature, backend=fn, device=self.device,
                **kw)
            return wav[0].cpu().numpy()

    def stream(self, num_samples: int, temperature: float, seed: int,
               chunk: int, prime=None):
        """Yield float32 waveform chunks (of at most ``chunk`` samples on
        the single-stream path; the pool's chunks with the batcher). The
        ring state carries across chunks; ``prime`` (flat class ids)
        replaces the mid-class cold start. A student draws the whole clip
        (at its bucket's length) in one pass, then yields it in chunks."""
        if self.backend == "iaf-student":
            with self.lock:
                wav = student_generate(
                    self.params, self.cfg,
                    torch.Generator().manual_seed(seed),
                    self.bucket(num_samples), device=self.device)
                wav = wav[0, :num_samples].cpu().numpy()
            for i in range(0, num_samples, chunk):
                yield wav[i:i + chunk]
            return
        if self.batcher is not None:
            yield from self._stream_batched(num_samples, temperature, seed,
                                            prime)
            return
        cfg = self.cfg
        first = (torch.full((1, 1), cfg.classes // 2, dtype=torch.int32)
                 if prime is None
                 else torch.as_tensor(np.asarray(prime, np.int32))[None])
        fn, noise, kw = self._single_stream(seed)
        state = None
        done = 0
        while done < num_samples:
            n = min(chunk, num_samples - done)
            with self.lock:
                wav, _, state = fn(
                    self.params, cfg, noise, n,
                    first if state is None else None,
                    temperature=temperature, state=state, return_state=True,
                    device=self.device, **kw)
                out = wav[0].cpu().numpy()
            done += n
            yield out


def make_handler(synth: Synthesizer, max_samples: int,
                 profile_dir: str | None = None,
                 snapshot_path: str | None = None):
    """The request handler class; ``profile_dir`` enables ``/profile``,
    ``snapshot_path`` is where ``/reload`` looks without a body."""
    profile_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            sys.stderr.write("%s - %s\n" % (self.address_string(),
                                            fmt % args))

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _params_from(self, query: dict, body: dict) -> dict:
            def pick(name, cast, default):
                if name in body:
                    return cast(body[name])
                if name in query:
                    return cast(query[name][0])
                return default

            req = {
                "num_samples": pick("num_samples", int, 16000),
                "temperature": pick("temperature", float, 1.0),
                "seed": pick("seed", int, 0),
                "chunk": pick("chunk", int, 2048),
                "prime": None,
            }
            if synth.backend == "iaf-student":
                if (body.get("prime") is not None
                        or body.get("prime_audio") is not None):
                    raise ValueError("the IAF student has no autoregressive "
                                     "history to prime")
                return req
            classes = synth.cfg.classes
            if body.get("prime") is not None:
                req["prime"] = np.asarray(body["prime"], np.int64)
                if (req["prime"].ndim != 1 or (req["prime"] < 0).any()
                        or (req["prime"] >= classes).any()):
                    raise ValueError(f"prime must be a flat list of class "
                                     f"ids in [0, {classes})")
            elif body.get("prime_audio") is not None:
                audio = np.asarray(body["prime_audio"], np.float64)
                if audio.ndim != 1:
                    raise ValueError("prime_audio must be a flat list of "
                                     "samples in [-1, 1]")
                req["prime"] = quantize_data(np.clip(audio, -1.0, 1.0),
                                             classes)
            if req["prime"] is not None:
                # only the last receptive_field samples reach the rollout
                # (the rings hold exactly that much history)
                rf = synth.cfg.receptive_field
                req["prime"] = req["prime"][-rf:].astype(np.int32)
            return req

        def _synthesize(self, body: dict):
            q = parse_qs(urlparse(self.path).query)
            try:
                req = self._params_from(q, body)
            except (ValueError, TypeError) as e:
                return self._json(400, {"error": f"bad parameter: {e}"})
            if not 0 < req["num_samples"] <= max_samples:
                return self._json(400, {"error": f"num_samples must be in "
                                                 f"(0, {max_samples}]"})
            if req["chunk"] < 1:
                return self._json(400, {"error": "chunk must be >= 1"})
            if req["prime"] is not None and req["prime"].size < 1:
                return self._json(400, {"error": "prime is empty"})

            gen = synth.stream(req["num_samples"], req["temperature"],
                               req["seed"], req["chunk"], req["prime"])
            # pull the first chunk BEFORE committing a 200: a full pool
            # still maps to an HTTP status instead of a truncated stream
            try:
                first = next(gen)
            except PoolOverloaded as e:
                return self._json(503, {"error": str(e)})
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length",
                             str(44 + req["num_samples"] * 2))
            self.end_headers()
            self.wfile.write(wav_header(req["num_samples"], synth.sr))
            try:
                for wav in itertools.chain([first], gen):
                    pcm = np.clip(wav * 32767.0, -32768, 32767)
                    self.wfile.write(pcm.astype("<i2").tobytes())
                    self.wfile.flush()
            except BrokenPipeError:
                gen.close()  # client hung up: stop at the chunk boundary

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/health":
                return self._json(200, {
                    "status": "ok",
                    "backend": synth.backend,
                    "receptive_field": synth.cfg.receptive_field,
                    "parameter_count": synth.parameter_count(),
                    "classes": getattr(synth.cfg, "classes", None),
                    "sample_rate": synth.sr,
                })
            if path == "/stats":
                out = {"backend": synth.backend}
                if synth.batcher is not None:
                    out.update(synth.batcher.stats())
                return self._json(200, out)
            if path == "/synthesize":
                return self._synthesize({})
            self._json(404, {"error": f"no route {path}"})

        def _vocode(self):
            if synth.cfg.cond_channels == 0:
                return self._json(400, {"error": "this model is "
                                        "unconditional (cfg.cond_channels "
                                        "== 0)"})
            length = int(self.headers.get("Content-Length", 0) or 0)
            if not 44 <= length <= 64 * 1024 * 1024:
                return self._json(
                    400, {"error": "body must be a wav upload (<= 64 MB)"})
            blob = self.rfile.read(length)
            q = parse_qs(urlparse(self.path).query)

            def qp(name, cast, default):
                return cast(q[name][0]) if name in q else default

            try:
                wav = synth.vocode(
                    blob, hop_length=qp("hop_length", int, 256),
                    n_fft=qp("n_fft", int, 1024),
                    temperature=qp("temperature", float, 1.0),
                    seed=qp("seed", int, 0), max_samples=max_samples)
            except PoolOverloaded as e:
                return self._json(503, {"error": str(e)})
            except (ValueError, TypeError, EOFError) as e:
                return self._json(400, {"error": str(e)})
            pcm = np.clip(wav * 32767.0, -32768, 32767).astype("<i2")
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(44 + pcm.size * 2))
            self.end_headers()
            self.wfile.write(wav_header(pcm.size, synth.sr))
            self.wfile.write(pcm.tobytes())

        def _body(self):
            """The request's JSON object body ({} without one), or None
            after answering 400."""
            length = int(self.headers.get("Content-Length", 0) or 0)
            body = {}
            if length:
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    self._json(400, {"error": "body is not JSON"})
                    return None
            if not isinstance(body, dict):
                self._json(400, {"error": "body must be a JSON object"})
                return None
            return body

        def _reload(self):
            body = self._body()
            if body is None:
                return
            try:
                step = synth.reload(body.get("snapshot"), snapshot_path,
                                    ema=bool(body.get("ema")))
            except (OSError, ValueError, KeyError) as e:
                return self._json(400, {"error": str(e)})
            except RuntimeError as e:  # the pool did not take the weights
                return self._json(503, {"error": str(e)})
            return self._json(200, {"reloaded": True, "step": step})

        def _profile(self):
            """A capture of whatever the server does for ``seconds``; one
            at a time, requests keep being served meanwhile."""
            if profile_dir is None:
                return self._json(
                    400, {"error": "start the server with --profile-dir"})
            q = parse_qs(urlparse(self.path).query)
            try:
                seconds = float(q.get("seconds", ["3"])[0])
            except ValueError:
                return self._json(400, {"error": "bad seconds"})
            seconds = min(max(seconds, 0.1), 60.0)
            if not profile_lock.acquire(blocking=False):
                return self._json(409, {"error": "a capture is running"})
            try:
                with profiling.trace(profile_dir) as path:
                    time.sleep(seconds)
            except Exception as e:  # the trace failed: report, keep serving
                return self._json(500, {"error": str(e)})
            finally:
                profile_lock.release()
            return self._json(200, {"trace": path, "seconds": seconds})

        def do_POST(self):
            path = urlparse(self.path).path
            if path == "/vocode":
                return self._vocode()
            if path == "/reload":
                return self._reload()
            if path == "/profile":
                return self._profile()
            if path != "/synthesize":
                return self._json(404, {"error": f"no route {path}"})
            body = self._body()
            if body is not None:
                self._synthesize(body)

    return Handler


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--snapshot-path", default="snapshots",
                   help="serve the newest checkpoint in this directory")
    p.add_argument("--snapshot", default=None, help="explicit checkpoint file")
    p.add_argument("--torch-snapshot", default=None,
                   help="serve a reference pytorch-wavenet snapshot "
                        "(whole-module pickle or bare state dict), converted "
                        "on load")
    p.add_argument("--torch-layers", type=int, default=None,
                   help="layers per block of a bare state dict")
    p.add_argument("--torch-blocks", type=int, default=None,
                   help="blocks of a bare state dict")
    p.add_argument("--backend", choices=BACKENDS, default="auto",
                   help="single stream: auto = K1 on the card, its plain "
                        "version on the CPU; plain = the plain PyTorch "
                        "rollout (generate_fast)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765, help="0 = any free port")
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--max-samples", type=int, default=16000 * 60,
                   help="per-request ceiling")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    p.add_argument("--batcher", action="store_true",
                   help="continuous batching: concurrent requests share one "
                        "pooled rollout of the batched kernel")
    p.add_argument("--lanes", type=int, default=128,
                   help="batcher lane-pool width (streams served at once)")
    p.add_argument("--batch-chunk", type=int, default=1024,
                   help="batcher splice granularity in samples (also the "
                        "time to first audio under load)")
    p.add_argument("--light-chunk", type=int, default=None,
                   help="batcher adaptive chunking: this many steps per "
                        "chunk while the pool is lightly loaded (responses "
                        "stay bitwise the same)")
    p.add_argument("--max-pending", type=int, default=None,
                   help="batcher admission control: requests beyond this "
                        "queue depth get HTTP 503")
    p.add_argument("--cond-hop", type=int, default=256,
                   help="batcher pools on conditioned models: the mel hop "
                        "the pool expands frames at (/vocode requests' "
                        "hop_length must match)")
    p.add_argument("--cond-wire", choices=("f32", "bf16"), default="f32",
                   help="mel-frame upload dtype of the batcher (bf16 halves "
                        "it; responses equal the solo rollout of "
                        "bf16-rounded frames)")
    p.add_argument("--bf16-rings", action="store_true",
                   help="batcher: store the pool's ring state in bfloat16 "
                        "(half the ring's bytes)")
    p.add_argument("--ema", action="store_true",
                   help="serve the snapshot's EMA weights "
                        "(training.train --ema-decay)")
    p.add_argument("--student-snapshot", default=None,
                   help="serve a distilled IAF student (training.distill_cli "
                        "checkpoint): a clip is one parallel pass; a "
                        "conditioned student also serves /vocode; prime and "
                        "temperature do not apply (the request's seed does)")
    p.add_argument("--reload-interval", type=float, default=0,
                   help="follow a training run: every N seconds roll the "
                        "newest checkpoint under --snapshot-path into the "
                        "running server when it changed")
    p.add_argument("--reload-ema", action="store_true",
                   help="with --reload-interval: roll in the snapshots' EMA "
                        "weights")
    p.add_argument("--profile-dir", default=None,
                   help="enable POST /profile?seconds=N: a torch.profiler "
                        "capture of the live server written here as a "
                        "Chrome trace (under --mesh-data: rank 0's "
                        "process, the HTTP front end, the scheduler and "
                        "its own lane block)")
    p.add_argument("--mesh-data", type=int, default=0,
                   help="shard the batcher lane pool over this many ranks "
                        "(a data-axis mesh, one rank a process, under "
                        "torch.distributed.run with as many; --lanes is the "
                        "POOL total, divisible by it). Per-request seeds "
                        "make responses identical to one process's.")
    return p.parse_args(argv)


def main(argv=None, on_ready=None):
    """Load the checkpoint, start the server and serve until interrupted or
    until ``server.shutdown()``. ``on_ready(server)`` is called once the
    socket is bound (its port is ``server.server_address[1]``)."""
    args = parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world > 1 and not args.batcher:
        raise SystemExit(f"{world} ranks without --batcher: only the lane "
                         f"pool spans ranks (--batcher --mesh-data "
                         f"{world}); the other ranks would have nothing "
                         f"to run")
    mesh, rank, device = None, 0, args.device
    if args.batcher and not args.student_snapshot and (
            args.mesh_data > 1 or world > 1):
        if args.mesh_data != world:
            raise SystemExit(f"--mesh-data {args.mesh_data} runs under "
                             f"torch.distributed.run with as many ranks "
                             f"(this launch has {world})")
        from ..parallel.mesh import init_distributed, make_mesh

        device = init_distributed(args.device, timeout=MESH_TIMEOUT)
        rank = torch.distributed.get_rank()
        mesh = make_mesh(args.mesh_data, 1)
    if args.student_snapshot:
        if args.ema:
            raise SystemExit("--ema applies to WaveNet snapshots")
        if args.batcher:
            raise SystemExit("--batcher is the AR lane pool; the student "
                             "already synthesizes whole clips in one pass")
        if args.torch_snapshot:
            raise SystemExit("--student-snapshot and --torch-snapshot name "
                             "two models: serve one")
        if args.reload_interval > 0:
            raise SystemExit("--reload-interval follows WaveNet snapshot "
                             "directories; the student backend cannot reload")
        params, scfg, step = load_student_snapshot(args.student_snapshot,
                                                   device=args.device)
        print(f"student at step {step}")
        synth = Synthesizer(params, scfg, args.sr, args.device, student=True)
        return _serve(args, synth, on_ready)
    if args.torch_snapshot:
        if args.ema:
            raise SystemExit("--ema applies to the framework's WaveNet "
                             "snapshots, not a reference snapshot")
        params, cfg = load_reference_snapshot(
            args.torch_snapshot, layers=args.torch_layers,
            blocks=args.torch_blocks, device=device)
        blob = {"params": params, "config": cfg, "opt_state": None}
    elif args.snapshot:
        blob = load_checkpoint(args.snapshot, device)
    else:
        blob = load_latest_model_from(args.snapshot_path, device)
    if blob["config"] is None:
        raise SystemExit("the checkpoint carries no config")
    cfg = blob["config"]
    params = blob["params"]
    if args.ema:
        ema = find_ema_state_dict(blob["opt_state"])
        if ema is None:
            raise SystemExit("--ema: this snapshot carries no EMA weights "
                             "(train with --ema-decay)")
        params = from_jax_params(ema, device)
        if rank == 0:
            print("serving EMA weights")
    batcher_opts = None
    if args.batcher:
        if args.backend == "plain":
            raise SystemExit("--backend chooses the single-stream path; "
                             "--batcher's pool is the kernel K4")
        batcher_opts = dict(lanes=args.lanes, chunk=args.batch_chunk,
                            light_chunk=args.light_chunk,
                            max_pending=args.max_pending, fuse_res=True,
                            # wide skips: the skip projection as one
                            # (L*D, S) product after the layer walk
                            skip_slab=cfg.skip_channels >= 256)
        if cfg.cond_channels:
            # conditioned pools take mel frames and expand them on the
            # device; the hop is the server's, /vocode requests must use it
            batcher_opts["cond_hop"] = args.cond_hop
            batcher_opts["cond_wire_dtype"] = (
                torch.bfloat16 if args.cond_wire == "bf16" else torch.float32)
        if args.bf16_rings:
            batcher_opts["ring_dtype"] = torch.bfloat16
    if mesh is not None:
        batcher_opts["mesh"] = mesh
        if rank > 0:  # this rank's lane block until rank 0 stops the pool
            return _mesh_exit(mesh, follow_pool(params, cfg, device=device,
                                                **batcher_opts))
    if batcher_opts is not None:
        synth = Synthesizer(params, cfg, args.sr, device,
                            batcher_opts=batcher_opts)
    else:
        synth = Synthesizer(params, cfg, args.sr, device,
                            backend=args.backend)
    if mesh is not None:
        print(f"mesh: rank 0 of {world} serves HTTP and schedules the pool "
              f"(pid {os.getpid()}); ranks 1-{world - 1} run their lane "
              f"blocks", flush=True)
        _serve(args, synth, on_ready)
        return _mesh_exit(mesh, synth.batcher.stats())
    return _serve(args, synth, on_ready)


def _mesh_exit(mesh, counters: dict):
    """After the pool has stopped: every rank's K4 launches, pool steps
    and prime calls (this rank's ``counters``), printed by rank 0
    (``kernel launches per rank: K4 [...]``, then ``pool steps per rank:
    [...]; prime calls per rank: [...]``), and the process group closed.
    A rank launches K4 once a pool step, once a prime call of its own and
    once for the prewarm's step."""
    from ..ops.cuda import gen_kernel_hbm as ghbm
    from ..parallel.mesh import DATA_AXIS, all_gather

    mine = torch.tensor([[ghbm.launches, counters["pool_steps"],
                          counters["prime_calls"]]])
    counts = all_gather(mine, mesh, DATA_AXIS).tolist()
    if torch.distributed.get_rank() == 0:
        k4, steps, primes = ([c[i] for c in counts] for i in range(3))
        print(f"kernel launches per rank: K4 {k4}", flush=True)
        print(f"pool steps per rank: {steps}; prime calls per rank: "
              f"{primes}", flush=True)
    torch.distributed.destroy_process_group()


def _follow(synth: Synthesizer, snapshot_path: str, interval: float,
            ema: bool, stop: threading.Event):
    """Roll each newer checkpoint under ``snapshot_path`` into ``synth``
    until ``stop`` is set; a failed reload is printed and retried at the
    next poll, the old weights serving meanwhile."""
    seen = latest_checkpoint(snapshot_path)
    while not stop.wait(interval):
        newest = latest_checkpoint(snapshot_path)
        if newest and newest != seen:
            try:
                step = synth.reload(newest, snapshot_path, ema=ema)
                print(f"rolled in {newest} (step {step})", flush=True)
                seen = newest
            except (ValueError, KeyError, OSError, RuntimeError) as e:
                print(f"reload of {newest} failed: {e}", flush=True)


def _serve(args, synth: Synthesizer, on_ready):
    # build the kernel and load it on the card before the first request
    next(synth.stream(1, 1.0, 0, 1))
    stop = threading.Event()
    follower = None
    if args.reload_interval > 0:
        follower = threading.Thread(
            target=_follow, args=(synth, args.snapshot_path,
                                  args.reload_interval, args.reload_ema,
                                  stop),
            daemon=True, name="snapshot-follower")
        follower.start()
    server = ThreadingHTTPServer(
        (args.host, args.port),
        make_handler(synth, args.max_samples, args.profile_dir,
                     args.snapshot_path))
    print(f"serving {synth.parameter_count():,}-param model on "
          f"http://{args.host}:{server.server_address[1]} "
          f"(backend: {synth.backend})", flush=True)
    if on_ready is not None:
        on_ready(server)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        stop.set()
        if follower is not None:
            follower.join()
        synth.close()  # finish in-flight clips, then stop the pool


if __name__ == "__main__":
    main()
