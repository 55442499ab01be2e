"""Training entry point of the port (the JAX package's ``scripts/train.py``).

  python -m pytorch_wavenet_tpu_torch.training.train --data-dir <wavs> \\
      --config chaconne_wide --batch-size 16 --snapshot-path snapshots
  python -m pytorch_wavenet_tpu_torch.training.train --data-dir <wavs> \\
      --config vocoder --cond-upsample 16,16 --batch-size 16

Builds the dataset (``<data-dir>/dataset.npz`` on first use; for a
conditioned config such as ``vocoder`` the mel dataset, whose batches
carry log-mel frames of ``--n-fft`` and ``--hop-length``, expanded to
per-sample rows in the step, through the learnable upsampler with
``--cond-upsample``), random params from ``--seed`` and the trainer,
optionally resumes from the newest snapshot (written by either package),
and trains. The trunk runs through the CUDA kernels K2/K3 (local
conditioning in them) unless ``--no-trunk-kernel`` (the plain PyTorch
trunk, as the JAX package's XLA trunk); ``--device cpu`` runs everything
with plain PyTorch ops. ``--bf16`` sets ``compute_dtype`` and
``stream_dtype`` to bfloat16 (bf16 matrix inputs, products summed in f32,
and a bf16 residual stream in K2/K3); snapshots carry both dtypes. The
JAX script's mesh, EMA, schedule, accumulation, SGD and TensorBoard flags
are not ported.
"""

from __future__ import annotations

import argparse
import os

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data-dir", required=True, help="directory of audio files")
    p.add_argument("--dataset-file", default=None,
                   help="npz cache (default: <data-dir>/dataset.npz)")
    p.add_argument("--config", default="chaconne",
                   help="preset name (chaconne|saber|chaconne_wide|vocoder|"
                        "test_small|tiny|tiny_vocoder)")
    p.add_argument("--n-fft", type=int, default=1024,
                   help="mel STFT size (conditioned configs)")
    p.add_argument("--hop-length", type=int, default=256,
                   help="mel hop in samples (conditioned configs)")
    p.add_argument("--cond-upsample", default=None,
                   help="comma-separated stride factors enabling the "
                        "learnable conditioning upsampler, e.g. 16,16; their "
                        "product must equal --hop-length (default: linear "
                        "interpolation)")
    p.add_argument("--no-trunk-kernel", action="store_true",
                   help="run the plain PyTorch trunk instead of K2/K3")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 matmul inputs and residual-stream storage "
                        "in the training trunk (cfg.compute_dtype and "
                        "cfg.stream_dtype); sums stay f32")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--clip", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--test-stride", type=int, default=500)
    p.add_argument("--snapshot-path", default="snapshots")
    p.add_argument("--snapshot-name", default=None)
    p.add_argument("--snapshot-interval", type=int, default=1000)
    p.add_argument("--log-interval", type=int, default=200)
    p.add_argument("--validation-interval", type=int, default=400)
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest snapshot")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Train as the flags say; returns the trainer."""
    from .. import config as config_mod
    from ..data.dataset import WaveNetDataset
    from ..data.mel_dataset import MelWaveNetDataset
    from ..device import resolve_device
    from ..models.wavenet import init_wavenet
    from ..utils.logging import Logger
    from .trainer import WaveNetTrainer

    args = parse_args(argv)
    dev = resolve_device(args.device)
    overrides = {"trunk_kernel": not args.no_trunk_kernel}
    if args.cond_upsample:
        overrides["cond_upsample"] = tuple(
            int(r) for r in args.cond_upsample.split(","))
    if args.bf16:
        overrides["compute_dtype"] = torch.bfloat16
        overrides["stream_dtype"] = torch.bfloat16
    cfg = config_mod.get_config(args.config, **overrides)
    params = init_wavenet(cfg, torch.Generator().manual_seed(args.seed), dev)
    print(f"config: {args.config} {cfg}")
    print(f"receptive field: {cfg.receptive_field}")
    print(f"parameter count: {cfg.parameter_count():,}")
    ds_kwargs = dict(
        dataset_file=args.dataset_file or os.path.join(args.data_dir,
                                                       "dataset.npz"),
        item_length=cfg.item_length, target_length=cfg.output_length,
        file_location=args.data_dir, classes=cfg.classes,
        test_stride=args.test_stride)
    if cfg.cond_channels:
        # mel frames per window; the step expands them on the device
        # (learnably with --cond-upsample, whose factors must multiply to
        # --hop-length: models.wavenet.upsample_cond checks)
        data = MelWaveNetDataset(**ds_kwargs, num_mels=cfg.cond_channels,
                                 n_fft=args.n_fft, hop_length=args.hop_length)
    else:
        data = WaveNetDataset(**ds_kwargs)
    print(f"the dataset has {len(data)} items")
    logger = Logger(log_interval=args.log_interval,
                    validation_interval=args.validation_interval,
                    generate_interval=10**12)
    trainer = WaveNetTrainer(
        cfg, params, data, lr=args.lr, weight_decay=args.weight_decay,
        gradient_clipping=args.clip, logger=logger,
        snapshot_path=args.snapshot_path,
        snapshot_name=args.snapshot_name or f"{args.config}_model",
        snapshot_interval=args.snapshot_interval, seed=args.seed, device=dev)
    start = 0
    if args.resume:
        start = trainer.resume()
        print(f"resuming at step {start}")
    print("start training...")
    trainer.train(batch_size=args.batch_size, epochs=args.epochs,
                  continue_training_at_step=start, max_steps=args.max_steps)
    return trainer


if __name__ == "__main__":
    main()
