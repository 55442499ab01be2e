"""Synthesize a small seeded "music" dataset for demos and training smoke
runs (the JAX package's ``scripts/make_demo_data.py``; numpy only).

The reference trains on a Bach chaconne recording that is not
redistributable with this repo (reference: train_script.py:38-42 points at
train_samples/bach_chaconne). This writes a deterministic few minutes of
polyphonic harmonic audio (melody and chord voices with ADSR envelopes,
per-voice harmonic rolloff and slight vibrato), rich enough for the model
to learn audible structure while staying reproducible. The samples and the
wav files equal the JAX script's for the same arguments.

  python -m pytorch_wavenet_tpu_torch.scripts.make_demo_data \\
      --out train_samples/demo --minutes 8
  python -m pytorch_wavenet_tpu_torch.training.train --config chaconne_wide \\
      --data-dir train_samples/demo
"""

from __future__ import annotations

import argparse
import os

import numpy as np

SR = 16000
# A harmonic minor-ish scale over two octaves (Hz), loosely A3-A5
SCALE = np.array([220.0, 246.9, 261.6, 293.7, 329.6, 349.2, 415.3,
                  440.0, 493.9, 523.3, 587.3, 659.3, 698.5, 830.6, 880.0])
CHORDS = [  # root indices into SCALE for a i-iv-V-i style loop
    (0, 2, 4), (3, 5, 7), (4, 6, 8), (0, 2, 4),
]


def _adsr(n, a=0.02, d=0.08, s=0.6, r=0.1):
    """Attack/decay/sustain/release envelope over n samples."""
    na, nd, nr = (int(x * SR) for x in (a, d, r))
    ns = max(n - na - nd - nr, 0)
    env = np.concatenate([
        np.linspace(0.0, 1.0, na, endpoint=False),
        np.linspace(1.0, s, nd, endpoint=False),
        np.full(ns, s),
        np.linspace(s, 0.0, nr),
    ])
    return env[:n] if len(env) >= n else np.pad(env, (0, n - len(env)))


def _voice(f0, n, rng, partials=6, vibrato=0.003, rolloff=1.6):
    """One note: harmonic stack with rolloff, slight vibrato and detune."""
    t = np.arange(n) / SR
    vib = 1.0 + vibrato * np.sin(2 * np.pi * 5.5 * t + rng.uniform(0, 6.28))
    phase = np.cumsum(f0 * vib) / SR * 2 * np.pi
    out = np.zeros(n)
    for h in range(1, partials + 1):
        amp = h ** -rolloff * rng.uniform(0.8, 1.2)
        out += amp * np.sin(h * phase + rng.uniform(0, 6.28))
    return out * _adsr(n)


def synthesize(minutes: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    total = int(minutes * 60 * SR)
    wav = np.zeros(total + 2 * SR)
    pos = 0
    bar = 0
    while pos < total:
        chord = CHORDS[bar % len(CHORDS)]
        bar_len = int(rng.uniform(1.6, 2.4) * SR)
        # sustained chord voices, one octave down, quiet
        for idx in chord:
            f = SCALE[idx] / 2
            wav[pos: pos + bar_len] += 0.12 * _voice(
                f, bar_len, rng, partials=4, rolloff=2.0
            )
        # melody: a few notes per bar walking the scale near the chord
        t = pos
        center = chord[rng.integers(0, 3)]
        while t < pos + bar_len:
            dur = int(rng.uniform(0.15, 0.5) * SR)
            dur = min(dur, pos + bar_len - t)
            center = int(np.clip(center + rng.integers(-2, 3), 0,
                                 len(SCALE) - 1))
            wav[t: t + dur] += 0.3 * _voice(SCALE[center], dur, rng)
            t += dur
        pos += bar_len
        bar += 1
    wav = wav[:total]
    return (wav / (np.abs(wav).max() + 1e-9) * 0.85).astype(np.float32)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--out", default="train_samples/demo")
    p.add_argument("--minutes", type=float, default=8.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--files", type=int, default=4,
                   help="split into this many wav files (exercises the "
                        "dataset's multi-file stitching)")
    return p.parse_args(argv)


def main(argv=None) -> list[str]:
    """Write the wav files; returns their paths."""
    args = parse_args(argv)
    from ..data.audio_io import write_wav

    os.makedirs(args.out, exist_ok=True)
    wav = synthesize(args.minutes, args.seed)
    per = len(wav) // args.files
    paths = []
    for i in range(args.files):
        chunk = (wav[i * per: (i + 1) * per] if i < args.files - 1
                 else wav[i * per:])
        path = os.path.join(args.out, f"demo_{i}.wav")
        write_wav(path, chunk, SR)
        print(f"wrote {path} ({len(chunk)/SR:.1f} s)")
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
