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
and a bf16 residual stream in K2/K3); snapshots carry both dtypes.

The optimizer is built as the JAX script builds it
(``optimizers.build_optimizer``): ``--optimizer adam`` with
``--lr-schedule`` (``constant``, ``cosine``, ``exponential``),
``--warmup-steps``, ``--decay-steps`` and ``--min-lr-ratio``, or
``--optimizer sgd_normalized`` with ``--momentum`` (which refuses a
schedule); ``--ema-decay`` tracks an EMA of the weights in the optimizer
state (serve it with ``serving.server --ema``); ``--accum-steps k`` applies
the optimizer every k micro-batches, the EMA inside the accumulation.
``--max-steps`` and ``--snapshot-interval`` count micro-batches.

``--log-dir`` writes a TensorBoard event file (loss, validation, parameter
and gradient histograms). Every ``--generate-interval`` steps
``generate_and_log_samples`` runs on the logger's daemon thread: it loads
the newest snapshot and generates ``--generate-length`` samples at
temperatures 0.5 and 1.0 in one rollout (K4 on the card), logged as audio
with ``--log-dir``.

Data- and model-parallel training: one rank a process, launched by
torchrun,

  python -m torch.distributed.run --standalone --nproc-per-node N \\
      -m pytorch_wavenet_tpu_torch.training.train ... --mesh-data D \\
      --mesh-model M

(``D x M`` must be the world size; ``--mesh-data 0``, the default, puts
every rank not on the model axis on the data axis). ``--batch-size`` is
the global batch, each rank takes its data index's block; snapshots are
sharded (each rank writes its blocks), ``--resume`` reads either format
under any mesh. Only rank 0 prints and writes TensorBoard; the audio hook
runs on rank 0 with the full params, gathered by every rank on the
training thread. The backend is NCCL when every rank has a card of its
own, gloo when ranks share one or run on the CPU (``--device cpu``); it
is printed.
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
    p.add_argument("--optimizer", default="adam",
                   choices=["adam", "sgd_normalized"],
                   help="adam (the reference trainer's default) or the "
                        "reference's SGDNormalized")
    p.add_argument("--momentum", type=float, default=0.0,
                   help="sgd_normalized momentum")
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--clip", type=float, default=None)
    p.add_argument("--lr-schedule", default="constant",
                   choices=("constant", "cosine", "exponential"),
                   help="cosine decays to lr*min-lr-ratio over "
                        "--decay-steps; exponential multiplies by "
                        "min-lr-ratio every decay-steps")
    p.add_argument("--warmup-steps", type=int, default=0,
                   help="linear 0 -> lr ramp before the schedule")
    p.add_argument("--decay-steps", type=int, default=None)
    p.add_argument("--min-lr-ratio", type=float, default=0.0)
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient accumulation: apply the optimizer every "
                        "k micro-batches (effective batch k * batch-size)")
    p.add_argument("--ema-decay", type=float, default=None,
                   help="track an exponential moving average of the "
                        "weights in the optimizer state (e.g. 0.9995); "
                        "serve it with serving.server --ema")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--test-stride", type=int, default=500)
    p.add_argument("--snapshot-path", default="snapshots")
    p.add_argument("--snapshot-name", default=None)
    p.add_argument("--snapshot-interval", type=int, default=1000)
    p.add_argument("--log-dir", default=None, help="TensorBoard log dir")
    p.add_argument("--log-interval", type=int, default=200)
    p.add_argument("--validation-interval", type=int, default=400)
    p.add_argument("--generate-interval", type=int, default=800)
    p.add_argument("--generate-length", type=int, default=32000)
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest snapshot")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--mesh-data", type=int, default=0,
                   help="data-axis size (0 = every rank not on the model "
                        "axis)")
    p.add_argument("--mesh-model", type=int, default=1)
    return p.parse_args(argv)


def main(argv=None):
    """Train as the flags say; returns the trainer."""
    from .. import config as config_mod
    from ..data.dataset import WaveNetDataset
    from ..data.mel_dataset import MelWaveNetDataset
    from ..device import resolve_device
    from ..models.wavenet import init_wavenet
    from ..parallel.mesh import init_distributed, make_mesh, mesh_shape
    from ..utils.checkpoints import load_latest_model_from
    from ..utils.logging import Logger, RankLogger, TensorboardLogger
    from .optimizers import build_optimizer, lr_schedule
    from .trainer import WaveNetTrainer, generate_audio

    args = parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", 1))
    mesh, rank = None, 0
    if world > 1:
        dev = init_distributed(args.device)
        rank = torch.distributed.get_rank()
    else:
        dev = resolve_device(args.device)
    if world > 1 or args.mesh_data > 1 or args.mesh_model > 1:
        # raises unless --mesh-data x --mesh-model is the world size
        mesh = make_mesh(args.mesh_data or None, args.mesh_model)
    say = print if rank == 0 else (lambda *a, **k: None)
    if mesh is not None:
        say(f"mesh: {mesh_shape(mesh)}")
    overrides = {"trunk_kernel": not args.no_trunk_kernel}
    if args.cond_upsample:
        overrides["cond_upsample"] = tuple(
            int(r) for r in args.cond_upsample.split(","))
    if args.bf16:
        overrides["compute_dtype"] = torch.bfloat16
        overrides["stream_dtype"] = torch.bfloat16
    cfg = config_mod.get_config(args.config, **overrides)
    params = init_wavenet(cfg, torch.Generator().manual_seed(args.seed), dev)
    say(f"config: {args.config} {cfg}")
    say(f"receptive field: {cfg.receptive_field}")
    say(f"parameter count: {cfg.parameter_count():,}")
    ds_kwargs = dict(
        dataset_file=args.dataset_file or os.path.join(args.data_dir,
                                                       "dataset.npz"),
        item_length=cfg.item_length, target_length=cfg.output_length,
        file_location=args.data_dir, classes=cfg.classes,
        test_stride=args.test_stride)
    if mesh is not None and rank > 0:
        torch.distributed.barrier()  # rank 0 builds the dataset file first
    if cfg.cond_channels:
        # mel frames per window; the step expands them on the device
        # (learnably with --cond-upsample, whose factors must multiply to
        # --hop-length: models.wavenet.upsample_cond checks)
        data = MelWaveNetDataset(**ds_kwargs, num_mels=cfg.cond_channels,
                                 n_fft=args.n_fft, hop_length=args.hop_length)
    else:
        data = WaveNetDataset(**ds_kwargs)
    if mesh is not None and rank == 0:
        torch.distributed.barrier()
    say(f"the dataset has {len(data)} items")

    def generate_and_log_samples(step, params=None):
        """The audio hook (reference: train_script.py:46-61), on the
        logger's daemon thread: the newest snapshot, one rollout at
        temperatures 0.5 and 1.0 seeded by the step, the clips logged. The
        checkpointer may be writing a newer snapshot meanwhile; writes are
        atomic (tmp + rename), so the hook reads the previous snapshot or
        the new one, each whole (the JAX script's order). Under a mesh the
        logger hands it the full params, gathered at this step."""
        if params is None:
            blob = load_latest_model_from(args.snapshot_path, device=dev)
            params, hook_cfg = blob["params"], blob["config"] or cfg
        else:
            hook_cfg = cfg
        temps = (0.5, 1.0)
        print("start generating...")
        clips = generate_audio(params, hook_cfg,
                               length=args.generate_length,
                               temperatures=temps, seed=step, device=dev)
        if isinstance(logger, TensorboardLogger):
            for temp, clip in zip(temps, clips):
                logger.audio_summary(f"temperature_{temp}", clip, step,
                                     sr=16000)
            logger.flush()
        print("audio clips generated")

    log_kw = dict(log_interval=args.log_interval,
                  validation_interval=args.validation_interval,
                  generate_interval=args.generate_interval,
                  generate_function=generate_and_log_samples)
    if rank > 0:
        logger = RankLogger(**{k: v for k, v in log_kw.items()
                               if k != "generate_function"})
    elif args.log_dir is not None:
        logger = TensorboardLogger(**log_kw, log_dir=args.log_dir)
    else:
        logger = Logger(**log_kw)
    # the JAX script's refusals, in its order
    if args.optimizer == "sgd_normalized" and not isinstance(
            lr_schedule(args.lr, args.lr_schedule, args.warmup_steps,
                        args.decay_steps, args.min_lr_ratio), float):
        raise SystemExit("--lr-schedule/--warmup-steps only apply to the "
                         "adam optimizer")
    optimizer = build_optimizer(
        args.optimizer, args.lr, args.momentum, args.weight_decay, args.clip,
        args.lr_schedule, args.warmup_steps, args.decay_steps,
        args.min_lr_ratio, args.ema_decay, args.accum_steps)
    trainer = WaveNetTrainer(
        cfg, params, data, optimizer=optimizer, logger=logger,
        snapshot_path=args.snapshot_path,
        snapshot_name=args.snapshot_name or f"{args.config}_model",
        snapshot_interval=args.snapshot_interval, seed=args.seed, device=dev,
        mesh=mesh)
    start = 0
    if args.resume:
        start = trainer.resume()
        say(f"resuming at step {start}")
    say("start training...")
    trainer.train(batch_size=args.batch_size, epochs=args.epochs,
                  continue_training_at_step=start, max_steps=args.max_steps)
    if isinstance(logger, TensorboardLogger):
        logger.flush()
    if mesh is not None:
        _print_launches(mesh, rank)
    return trainer


def _print_launches(mesh, rank: int) -> None:
    """Rank 0 prints every rank's kernel launches in this process
    (``kernel launches per rank: K2 [...], K3 [...], K4 [...]``, rank
    order): a multi-rank run's counts live in its ranks' processes."""
    from ..ops.cuda import gen_kernel_hbm as ghbm
    from ..ops.cuda import trunk_kernel as tk
    from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, all_gather

    counts = torch.tensor([[tk.fwd_launches, tk.bwd_launches,
                            ghbm.launches]])
    counts = all_gather(all_gather(counts, mesh, MODEL_AXIS), mesh,
                        DATA_AXIS)
    if rank == 0:
        k2, k3, k4 = counts.T.tolist()
        print(f"kernel launches per rank: K2 {k2}, K3 {k3}, K4 {k4}",
              flush=True)


if __name__ == "__main__":
    main()
