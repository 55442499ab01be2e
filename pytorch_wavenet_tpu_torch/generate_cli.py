"""Generation entry point of the port (the JAX package's
``scripts/generate.py``).

  python -m pytorch_wavenet_tpu_torch.generate_cli --snapshot-path snapshots \\
      --data-dir train_samples/bach_chaconne --num-samples 16000 \\
      --temperature 1.0 --out latest_generated_clip.wav
  python -m pytorch_wavenet_tpu_torch.generate_cli --torch-snapshot ref.pt
  python -m pytorch_wavenet_tpu_torch.generate_cli --snapshot vocoder.ckpt \\
      --vocode-wav in.wav --out resynth.wav

Loads a snapshot (the newest under ``--snapshot-path``, an explicit
``--snapshot``, or a reference pytorch-wavenet snapshot converted on load
with ``--torch-snapshot``), primes from a dataset window or one mid-class
sample per stream, generates on the card and writes 16-bit wavs (one per
stream, ``{stem}_{i}{ext}`` beyond one).

The path is picked by the port's own rule: on the card, up to
``MAX_STREAMS`` (8) streams of a model whose buffers fit one cluster's
shared memory take the fused kernel K1 (``generate_fast_fused``;
``fuse_res`` unless ``--exact-chain``); anything else takes the batched
kernel K4 (``generate_fast_batched``: ``fuse_res`` unless
``--exact-chain``, ``skip_slab`` at a skip width of 256 or more, bf16 rings
with ``--bf16-rings``). ``--device cpu`` takes the same choice, and the
wrappers run their plain versions there. The CLI prints the call it made
and the kernel launches it counted. ``--seed`` is the kernels' noise seed.
Mel modes (``--mel-file``, ``--vocode-wav``) run ``synthesize`` on the
chosen kernel. ``--head-tiles`` is not ported: it was a TPU memory lever.

``--draft-snapshot`` runs speculative decoding (plain PyTorch, one
stream, temperature 0). On the card it is refused whenever K1 runs the
model, unless ``--force-speculate``: there it ran 64-213x slower than K1
(PERF.md §6, an NVIDIA H100 80GB HBM3 at 700.00 W).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .data.audio_io import load_audio, write_wav
from .data.dataset import WaveNetDataset
from .device import resolve_device
from .models.convert import from_jax_params, load_reference_snapshot
from .models.generate import synthesize
from .models.speculative import speculative_generate
from .ops.cuda import gen_kernel as gk
from .ops.cuda import gen_kernel_hbm as ghbm
from .ops.mel import log_mel_spectrogram
from .training.optimizers import find_ema_state_dict
from .utils.checkpoints import load_checkpoint, load_latest_model_from


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--snapshot-path", default="snapshots",
                   help="generate from the newest checkpoint in this "
                        "directory")
    p.add_argument("--snapshot", default=None, help="explicit checkpoint file")
    p.add_argument("--torch-snapshot", default=None,
                   help="a reference torch snapshot (whole-module pickle or "
                        "bare state dict), converted on load")
    p.add_argument("--torch-layers", type=int, default=None,
                   help="layers per block of a bare state dict (whole-module "
                        "pickles carry it)")
    p.add_argument("--torch-blocks", type=int, default=None)
    p.add_argument("--data-dir", default=None,
                   help="dataset directory to prime from (the last "
                        "receptive_field samples of an item)")
    p.add_argument("--prime-index", type=int, default=0)
    p.add_argument("--num-samples", type=int, default=16000)
    p.add_argument("--mel-file", default=None,
                   help="npy of log-mel frames (F, M) or (S, F, M): run the "
                        "conditioned model over them (cond_channels == M)")
    p.add_argument("--vocode-wav", default=None,
                   help="copy-synthesis: this wav's log-mel frames drive the "
                        "conditioned model")
    p.add_argument("--hop-length", type=int, default=256,
                   help="mel hop in samples (vocoder modes)")
    p.add_argument("--n-fft", type=int, default=1024,
                   help="mel STFT size (--vocode-wav)")
    p.add_argument("--num-streams", type=int, default=1)
    p.add_argument("--exact-chain", action="store_true",
                   help="the kernels keep the exact per-layer chain instead "
                        "of fuse_res (pre-multiplied residual weights: the "
                        "same function, sums reassociated)")
    p.add_argument("--bf16-rings", action="store_true",
                   help="K4: store the ring state in bfloat16")
    p.add_argument("--draft-snapshot", default=None,
                   help="speculative decoding: a smaller WaveNet snapshot "
                        "(file or directory) drafts k samples and the model "
                        "verifies them in one window pass (argmax rollout, "
                        "one stream)")
    p.add_argument("--speculate-k", type=int, default=8,
                   help="speculation depth per verify pass")
    p.add_argument("--force-speculate", action="store_true",
                   help="run --draft-snapshot even where K1 runs the model "
                        "(K1 measured 64-213x faster on an H100: PERF.md)")
    p.add_argument("--ema", action="store_true",
                   help="generate from the snapshot's EMA weights "
                        "(training.train --ema-decay)")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--regularize", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="latest_generated_clip.wav")
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    return p.parse_args(argv)


def k1_runs(cfg, streams: int, fuse_res: bool, cond: bool) -> bool:
    """Whether K1 takes ``streams`` streams of ``cfg``: at most
    ``MAX_STREAMS`` and buffers that fit one block of its cluster."""
    if streams > gk.MAX_STREAMS:
        return False
    rows = gk.cond_rows(cfg, gk.CLUSTER, fuse_res) if cond else 0
    try:
        gk.cluster_fits(cfg, gk.MAX_STREAMS, gk.CLUSTER, fuse_res, rows)
    except ValueError:
        return False
    return True


def pick_path(cfg, args, cond: bool):
    """(backend function, its keyword arguments, a description, the
    wrapper module whose ``launches`` counts it) by the module
    docstring's rule."""
    fuse = not args.exact_chain
    if k1_runs(cfg, args.num_streams, fuse, cond):
        kw = {"fuse_res": fuse}
        return gk.generate_fast_fused, kw, "K1 generate_fast_fused", gk
    kw = {"fuse_res": fuse, "skip_slab": cfg.skip_channels >= 256}
    if args.bf16_rings:
        kw["ring_dtype"] = torch.bfloat16
    return ghbm.generate_fast_batched, kw, "K4 generate_fast_batched", ghbm


def _load(args, dev):
    """(params, cfg, opt_state) of the snapshot the flags name."""
    if args.torch_snapshot:
        params, cfg = load_reference_snapshot(
            args.torch_snapshot, layers=args.torch_layers,
            blocks=args.torch_blocks, device=dev)
        return params, cfg, None
    blob = (load_checkpoint(args.snapshot, dev) if args.snapshot
            else load_latest_model_from(args.snapshot_path, dev))
    if blob["config"] is None:
        raise SystemExit("the checkpoint carries no config")
    return blob["params"], blob["config"], blob["opt_state"]


def _mel(args, cfg):
    """The conditioning frames of a vocoder mode, or None."""
    mel = None
    if args.vocode_wav:
        wav_in, sr = load_audio(args.vocode_wav, sampling_rate=args.sr)
        mel = log_mel_spectrogram(wav_in, num_mels=cfg.cond_channels,
                                  n_fft=args.n_fft,
                                  hop_length=args.hop_length,
                                  sampling_rate=sr)
        print(f"copy-synthesis: {len(wav_in)} samples -> {mel.shape[0]} "
              f"mel frames")
    elif args.mel_file:
        mel = np.load(args.mel_file).astype(np.float32)
        print(f"mel frames: {mel.shape}")
    if mel is not None and cfg.cond_channels == 0:
        raise SystemExit("vocoder mode needs a conditioned model "
                         "(cfg.cond_channels > 0)")
    if mel is not None and mel.ndim == 2 and args.num_streams > 1:
        mel = np.tile(mel[None], (args.num_streams, 1, 1))
    return mel


def _write(args, wav: np.ndarray):
    if args.num_streams == 1:
        write_wav(args.out, wav[0], args.sr)
        print(f"wrote {args.out}")
        return
    stem, ext = os.path.splitext(args.out)
    for i in range(args.num_streams):
        write_wav(f"{stem}_{i}{ext}", wav[i], args.sr)
    print(f"wrote {args.num_streams} files {stem}_*{ext}")


def main(argv=None) -> np.ndarray:
    """Generate as the flags say and write the wavs; returns the waveforms
    ``(streams, samples)``."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    params, cfg, opt_state = _load(args, dev)
    if args.ema:
        ema = None if opt_state is None else find_ema_state_dict(opt_state)
        if ema is None:
            raise SystemExit("--ema: this snapshot carries no EMA weights "
                             "(train with --ema-decay)")
        params = from_jax_params(ema, dev)
        print("generating from EMA weights")
    print(f"receptive field: {cfg.receptive_field}")
    print(f"parameter count: {cfg.parameter_count():,}")

    # one mid-class sample per stream, or a dataset window's tail
    first = np.full((args.num_streams, 1), cfg.classes // 2, np.int64)
    if args.data_dir:
        data = WaveNetDataset(
            os.path.join(args.data_dir, "dataset.npz"),
            item_length=cfg.item_length, target_length=cfg.output_length,
            file_location=args.data_dir, classes=cfg.classes, test_stride=20)
        x, _ = data[min(args.prime_index, len(data) - 1)]
        prime = np.asarray(x[-cfg.receptive_field:], np.int64)
        first = np.tile(prime[None, :], (args.num_streams, 1))
    mel = _mel(args, cfg)

    if args.draft_snapshot:
        if mel is not None:
            raise SystemExit("--draft-snapshot does not combine with the "
                             "vocoder modes")
        if args.num_streams != 1:
            raise SystemExit("speculative decoding is single-stream")
        if (dev.type == "cuda" and not args.force_speculate
                and k1_runs(cfg, 1, not args.exact_chain, False)):
            raise SystemExit(
                "--draft-snapshot: K1 runs this model, and speculative "
                "decoding ran 64-213x slower than K1 (PERF.md §6, an "
                "NVIDIA H100 80GB HBM3 at 700.00 W). Drop --draft-snapshot "
                "to take K1, or pass --force-speculate to speculate anyway.")
        dblob = (load_checkpoint(args.draft_snapshot, dev)
                 if os.path.isfile(args.draft_snapshot)
                 else load_latest_model_from(args.draft_snapshot, dev))
        dcfg = dblob["config"]
        print(f"speculative decoding: draft {dcfg.parameter_count():,} "
              f"params, k={args.speculate_k} (argmax rollout)")
        t0 = time.perf_counter()
        wav, _, rate = speculative_generate(
            params, cfg, dblob["params"], dcfg, None, args.num_samples,
            first, k=args.speculate_k, device=dev)
        wav = wav.cpu().numpy()
        dt = time.perf_counter() - t0
        print(f"{wav.size} samples in {dt:.2f} s ({wav.size / dt:.0f} "
              f"samples/s), accept rate {float(rate):.2f}/"
              f"{args.speculate_k} per verify pass")
        _write(args, wav)
        return wav

    gen, kw, name, counted = pick_path(cfg, args, mel is not None)
    print(f"generation path: {name}("
          f"{', '.join(f'{k}={v}' for k, v in kw.items())})"
          + (" (its plain version on the CPU)" if dev.type == "cpu" else ""))
    launched = counted.launches
    t0 = time.perf_counter()
    if mel is not None:
        wav, _ = synthesize(params, cfg, args.seed, mel, args.hop_length,
                            first, temperature=args.temperature,
                            regularize=args.regularize, backend=gen,
                            device=dev, **kw)
    else:
        wav, _ = gen(params, cfg, args.seed, args.num_samples, first,
                     temperature=args.temperature,
                     regularize=args.regularize, device=dev, **kw)
    wav = wav.cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"kernel launches: {counted.launches - launched}")
    print(f"{wav.size} samples in {dt:.2f} s ({wav.size / dt:.0f} "
          f"samples/s)")
    _write(args, wav)
    return wav


if __name__ == "__main__":
    main()
