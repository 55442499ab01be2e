"""Training entry point of the port (the JAX package's ``scripts/train.py``).

  python -m pytorch_wavenet_tpu_torch.training.train --data-dir <wavs> \\
      --config chaconne_wide --batch-size 16 --snapshot-path snapshots

Builds the dataset (``<data-dir>/dataset.npz`` on first use), random params
from ``--seed`` and the trainer, optionally resumes from the newest snapshot
(written by either package), and trains. The trunk runs through the CUDA
kernels K2/K3 unless ``--no-trunk-kernel`` (the plain PyTorch trunk, as the
JAX package's XLA trunk); ``--device cpu`` runs everything with plain
PyTorch ops. The JAX script's conditioning, mesh, EMA, schedule,
accumulation, SGD and TensorBoard flags are not ported.
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
                   help="preset name (chaconne|saber|chaconne_wide|"
                        "test_small|tiny)")
    p.add_argument("--no-trunk-kernel", action="store_true",
                   help="run the plain PyTorch trunk instead of K2/K3")
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
    from ..device import resolve_device
    from ..models.wavenet import init_wavenet
    from ..utils.logging import Logger
    from .trainer import WaveNetTrainer

    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = config_mod.get_config(args.config,
                                trunk_kernel=not args.no_trunk_kernel)
    params = init_wavenet(cfg, torch.Generator().manual_seed(args.seed), dev)
    print(f"config: {args.config} {cfg}")
    print(f"receptive field: {cfg.receptive_field}")
    print(f"parameter count: {cfg.parameter_count():,}")
    data = WaveNetDataset(
        dataset_file=args.dataset_file or os.path.join(args.data_dir,
                                                       "dataset.npz"),
        item_length=cfg.item_length, target_length=cfg.output_length,
        file_location=args.data_dir, classes=cfg.classes,
        test_stride=args.test_stride)
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
