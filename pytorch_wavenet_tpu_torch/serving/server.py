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

``--ema`` serves the exponential moving average of the weights that a
snapshot trained with ``--ema-decay`` carries in its optimizer state
(written by either package), on either path.

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
  python -m pytorch_wavenet_tpu_torch.serving.server --snapshot model.ckpt --ema
  python -m pytorch_wavenet_tpu_torch.serving.server --student-snapshot student.ckpt
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
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..data.audio_io import load_audio
from ..device import resolve_device
from ..models.convert import from_jax_params
from ..models.generate import synthesize
from ..models.iaf import (load_student_snapshot, student_generate,
                          student_parameter_count, student_synthesize)
from ..models.wavenet import params_to
from ..ops.cuda.gen_kernel import generate_fast_fused
from ..ops.mel import log_mel_spectrogram
from ..ops.mulaw import dequantize_to_f32, quantize_data
from ..training.optimizers import find_ema_state_dict
from ..utils.checkpoints import load_checkpoint, load_latest_model_from
from .batcher import ContinuousBatcher, PoolOverloaded


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


class Synthesizer:
    """Owns the model on one device and runs rollouts chunk by chunk
    through the fused generation kernel, or, with ``batcher_opts``
    (:class:`ContinuousBatcher` keyword arguments), splices concurrent
    requests into one pooled rollout of the batched kernel (the plain
    versions on the CPU). With ``student``, ``cfg`` is an ``IAFConfig`` and
    every clip is one parallel pass of the student (backend
    ``iaf-student``)."""

    def __init__(self, params, cfg, sr: int = 16000,
                 device: str | torch.device = "cuda",
                 batcher_opts: dict | None = None, student: bool = False):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.sr = sr
        self.lock = threading.Lock()
        self.batcher = None
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
                            else "cpu-plain")

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
        (fuse_res); with the batcher, the frames ride the pool
        (``cond_frames``) and the request's seed keys its lane's noise.
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
        with self.lock:
            wav, _ = synthesize(
                self.params, self.cfg, self.kernel_seed(seed), mel,
                hop_length, temperature=temperature,
                backend=generate_fast_fused, fuse_res=True,
                device=self.device)
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
        kernel_seed = self.kernel_seed(seed)
        state = None
        done = 0
        while done < num_samples:
            n = min(chunk, num_samples - done)
            with self.lock:
                wav, _, state = generate_fast_fused(
                    self.params, cfg, kernel_seed, n,
                    first if state is None else None,
                    temperature=temperature, state=state, return_state=True,
                    fuse_res=True, device=self.device)
                out = wav[0].cpu().numpy()
            done += n
            yield out


def make_handler(synth: Synthesizer, max_samples: int):
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

        def do_POST(self):
            path = urlparse(self.path).path
            if path == "/vocode":
                return self._vocode()
            if path != "/synthesize":
                return self._json(404, {"error": f"no route {path}"})
            length = int(self.headers.get("Content-Length", 0) or 0)
            body = {}
            if length:
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    return self._json(400, {"error": "body is not JSON"})
            if not isinstance(body, dict):
                return self._json(400, {"error": "body must be a JSON object"})
            self._synthesize(body)

    return Handler


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--snapshot-path", default="snapshots",
                   help="serve the newest checkpoint in this directory")
    p.add_argument("--snapshot", default=None, help="explicit checkpoint file")
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
    return p.parse_args(argv)


def main(argv=None, on_ready=None):
    """Load the checkpoint, start the server and serve until interrupted or
    until ``server.shutdown()``. ``on_ready(server)`` is called once the
    socket is bound (its port is ``server.server_address[1]``)."""
    args = parse_args(argv)
    if args.student_snapshot:
        if args.ema:
            raise SystemExit("--ema applies to WaveNet snapshots")
        if args.batcher:
            raise SystemExit("--batcher is the AR lane pool; the student "
                             "already synthesizes whole clips in one pass")
        params, scfg, step = load_student_snapshot(args.student_snapshot,
                                                   device=args.device)
        print(f"student at step {step}")
        synth = Synthesizer(params, scfg, args.sr, args.device, student=True)
        return _serve(args, synth, on_ready)
    if args.snapshot:
        blob = load_checkpoint(args.snapshot, args.device)
    else:
        blob = load_latest_model_from(args.snapshot_path, args.device)
    if blob["config"] is None:
        raise SystemExit("the checkpoint carries no config")
    cfg = blob["config"]
    params = blob["params"]
    if args.ema:
        ema = find_ema_state_dict(blob["opt_state"])
        if ema is None:
            raise SystemExit("--ema: this snapshot carries no EMA weights "
                             "(train with --ema-decay)")
        params = from_jax_params(ema, args.device)
        print("serving EMA weights")
    batcher_opts = None
    if args.batcher:
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
    synth = Synthesizer(params, cfg, args.sr, args.device,
                        batcher_opts=batcher_opts)
    return _serve(args, synth, on_ready)


def _serve(args, synth: Synthesizer, on_ready):
    # build the kernel and load it on the card before the first request
    next(synth.stream(1, 1.0, 0, 1))
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(synth, args.max_samples))
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
        synth.close()  # finish in-flight clips, then stop the pool


if __name__ == "__main__":
    main()
