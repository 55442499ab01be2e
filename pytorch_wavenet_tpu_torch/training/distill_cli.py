"""Parallel-WaveNet distillation entry point of the port (the JAX package's
``scripts/distill.py``).

  python -m pytorch_wavenet_tpu_torch.training.distill_cli \\
      --teacher-snapshot snapshots/chaconne_wide_model_0000000020.ckpt \\
      --data-dir examples --steps 1000 --out-dir students
  python -m pytorch_wavenet_tpu_torch.training.distill_cli \\
      --teacher-snapshot snapshots --steps 0 --generate 16000 \\
      --student-snapshot students/student_0000001000.ckpt --wav-out s.wav

Distills a teacher snapshot (written by either package's training CLI)
into an IAF student (``models/iaf.py``) by probability density
distillation (``training/distill.py``), then optionally generates audio in
one parallel pass. The teacher scores each draw through the forward trunk
kernel K2 on the card (local conditioning in it at a vocoder teacher)
unless ``--no-trunk-kernel`` (the plain PyTorch trunk), as the training
CLI decides; ``--device cpu`` runs everything with plain PyTorch ops.

Every flag of the JAX script keeps its default and its refusal. Student
snapshots carry ``extra={"iaf_config": ...}`` (``compute_dtype`` None), so
either package loads them. They also carry the optimizer's state (optax's
layout) and the count of reference batches consumed, so a run resumed
with ``--student-snapshot`` continues the uninterrupted one bitwise; the
JAX script restarts Adam and the data order on resume, and this CLI does
so for snapshots without them. Step i draws its noise from a generator
seeded by ``(seed + 1, i)``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--teacher-snapshot", required=True,
                   help="teacher .ckpt file or snapshot directory (the "
                        "newest is used)")
    p.add_argument("--teacher-ema", action="store_true",
                   help="distill against the teacher's EMA weights "
                        "(training.train --ema-decay)")
    p.add_argument("--flows", type=int, default=4)
    p.add_argument("--layers", type=int, default=10)
    p.add_argument("--blocks", type=int, default=1)
    p.add_argument("--width", type=int, default=64,
                   help="student residual/dilation/skip/end channels")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--length", type=int, default=4000,
                   help="student draw length per step (must exceed the "
                        "teacher's receptive field)")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--power-weight", type=float, default=0.0,
                   help="power-loss weight (needs --data-dir for reference "
                        "audio)")
    p.add_argument("--hop-length", type=int, default=256,
                   help="mel hop for conditioned (vocoder) teachers")
    p.add_argument("--n-fft", type=int, default=1024)
    p.add_argument("--data-dir", default=None,
                   help="audio dir for the reference batches")
    p.add_argument("--dataset-file", default=None)
    p.add_argument("--rms-weight", type=float, default=None,
                   help="log-RMS matching weight, the amplitude regulator "
                        "(default: 1.0 with --data-dir, else 0)")
    p.add_argument("--teacher-smooth", type=float, default=1e-3,
                   help="teacher label smoothing (against sharp teachers; "
                        "see training/distill.py)")
    p.add_argument("--init-scale", type=float, default=None,
                   help="fresh-student draw amplitude at init (default: "
                        "data rms / 1.8138 with --data-dir, else 0.1)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out-dir", default="students")
    p.add_argument("--name", default="student")
    p.add_argument("--save-interval", type=int, default=1000)
    p.add_argument("--log-interval", type=int, default=50)
    p.add_argument("--student-snapshot", default=None,
                   help="resume/generate from this student .ckpt")
    p.add_argument("--generate", type=int, default=0,
                   help="after training (or with --steps 0: at once), "
                        "generate this many samples per stream")
    p.add_argument("--streams", type=int, default=1)
    p.add_argument("--wav-out", default=None)
    p.add_argument("--no-trunk-kernel", action="store_true",
                   help="score the teacher with the plain PyTorch trunk "
                        "instead of K2")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def load_teacher(path: str, ema: bool, trunk_kernel: bool, device):
    """The teacher's params and config (with ``trunk_kernel`` set) from a
    checkpoint file or the newest one in a directory."""
    from ..models.convert import from_jax_params
    from ..utils.checkpoints import latest_checkpoint, load_checkpoint
    from .optimizers import find_ema_state_dict

    if os.path.isdir(path):
        path = latest_checkpoint(path)
        if path is None:
            raise SystemExit("no teacher checkpoint found")
    blob = load_checkpoint(path, device)
    if blob["config"] is None:
        raise SystemExit(f"{path} has no embedded config")
    params = blob["params"]
    if ema:
        source = find_ema_state_dict(blob["opt_state"])
        if source is None:
            raise SystemExit("--teacher-ema: snapshot carries no EMA "
                             "weights (train with --ema-decay)")
        params = from_jax_params(source, device)
    cfg = dataclasses.replace(blob["config"], trunk_kernel=trunk_kernel)
    print(f"teacher: {path} (step {blob['step']}, rf {cfg.receptive_field})")
    return params, cfg


def step_generator(seed: int, step: int) -> torch.Generator:
    """The generator of step ``step``'s base uniforms."""
    return torch.Generator().manual_seed((seed + 1) * 2**32 + step)


def main(argv=None):
    """Distill (and generate) as the flags say; returns a dict with the
    student's ``params``, ``scfg``, ``step``, the last snapshot ``path`` and
    the generated ``wav`` (or None)."""
    from ..data.dataset import BatchIterator, WaveNetDataset
    from ..device import resolve_device
    from ..models.iaf import (IAFConfig, init_student, load_student_snapshot,
                              student_generate, student_parameter_count,
                              student_state_dict)
    from ..models.wavenet import parameter_count
    from ..ops.mulaw import dequantize_data
    from ..utils.checkpoints import save_checkpoint
    from .distill import distill_step
    from .optimizers import reference_adam

    args = parse_args(argv)
    dev = resolve_device(args.device)
    teacher, tcfg = load_teacher(args.teacher_snapshot, args.teacher_ema,
                                 not args.no_trunk_kernel, dev)
    if tcfg.cond_channels and args.data_dir is None:
        raise SystemExit("a conditioned (vocoder) teacher distills on real "
                         "mel timelines: pass --data-dir")
    scfg = IAFConfig(
        flows=args.flows, layers=args.layers, blocks=args.blocks,
        residual_channels=args.width, dilation_channels=args.width,
        skip_channels=args.width, end_channels=args.width,
        cond_channels=tcfg.cond_channels)
    step0, consumed, opt_blob = 0, 0, None
    params = None  # a fresh init below, once the data rms is known
    if args.student_snapshot:
        from ..utils.checkpoints import load_checkpoint

        params, scfg, step0 = load_student_snapshot(args.student_snapshot,
                                                    scfg, dev)
        blob = load_checkpoint(args.student_snapshot, "cpu")
        opt_blob = blob["opt_state"]
        consumed = int((blob["extra"] or {}).get("distill_batches") or 0)
        print(f"student resumed at step {step0}")
        if scfg.cond_channels != tcfg.cond_channels:
            raise SystemExit(
                f"resumed student has cond_channels={scfg.cond_channels} "
                f"but the teacher expects {tcfg.cond_channels}: distill a "
                "matching student")
    if args.length <= tcfg.receptive_field:
        raise SystemExit(f"--length {args.length} must exceed teacher rf "
                         f"{tcfg.receptive_field}")

    if args.rms_weight is None:
        args.rms_weight = 1.0 if args.data_dir is not None else 0.0
    needs_ref = args.power_weight > 0.0 or args.rms_weight > 0.0
    if needs_ref and args.data_dir is None:
        raise SystemExit("--power-weight / --rms-weight need --data-dir")
    batches = {"n": consumed}
    ref_iter = cond_iter = None
    if args.data_dir is not None and (needs_ref or tcfg.cond_channels):
        ds = WaveNetDataset(
            args.dataset_file or os.path.join(args.data_dir, "dataset.npz"),
            item_length=args.length - 1, target_length=1,
            file_location=args.data_dir, classes=tcfg.classes)

        def ref_batches():
            n = 0
            while True:
                for x, _ in BatchIterator(ds, args.batch_size,
                                          seed=args.seed):
                    n += 1
                    if n <= consumed:  # a resumed run's batches so far
                        continue
                    batches["n"] = n
                    yield np.asarray(dequantize_data(x, tcfg.classes),
                                     np.float32)

        ref_iter = ref_batches()
        if tcfg.cond_channels:
            # vocoder distillation: both models see the mel timeline of a
            # real audio window, the reference is the same window
            from ..ops.mel import log_mel_spectrogram, upsample_frames_np

            def cond_batches():
                while True:
                    ref = next(ref_iter)
                    mels = np.stack([log_mel_spectrogram(
                        w, num_mels=tcfg.cond_channels, n_fft=args.n_fft,
                        hop_length=args.hop_length) for w in ref])
                    yield ref, upsample_frames_np(mels, args.hop_length,
                                                  args.length)

            cond_iter = cond_batches()

    if params is None:
        iscale = args.init_scale
        if iscale is None:
            if ref_iter is not None:  # amplitude-matched init
                ref = next(ref_iter)
                iscale = float(np.sqrt(np.mean(ref.astype(np.float32) ** 2)))
                iscale /= 1.8138  # Logistic(0, 1) std
            else:
                iscale = 0.1
        params = init_student(scfg, torch.Generator().manual_seed(args.seed),
                              init_scale=iscale, device=dev)
        print(f"student init_scale {iscale:.4f}")
    print(f"student: {scfg.flows} flows x {scfg.num_layers} layers, "
          f"{student_parameter_count(params):,} params (teacher "
          f"{parameter_count(teacher):,}); teacher trunk "
          f"{'K2' if tcfg.trunk_kernel else 'plain'} on {dev}")

    tx = reference_adam(args.lr, gradient_clipping=1.0)
    view = student_state_dict(params)
    opt = (tx.load_state_dict(opt_blob, view) if opt_blob is not None
           else tx.init(view))

    def save(step):
        return save_checkpoint(
            args.out_dir, args.name, step, params,
            extra={"iaf_config": dataclasses.asdict(
                       dataclasses.replace(scfg, compute_dtype=None)),
                   "distill_batches": batches["n"]},
            opt_state=tx.state_dict(opt))

    def put(x):
        return None if x is None else torch.from_numpy(
            np.ascontiguousarray(x, np.float32)).to(dev)

    path = None
    t0 = time.time()
    for i in range(step0, step0 + args.steps):
        cond = None
        if cond_iter is not None:
            ref, cond = next(cond_iter)
        else:
            ref = next(ref_iter) if ref_iter is not None else None
        params, opt, loss, aux = distill_step(
            params, opt, teacher, scfg, tcfg, tx,
            step_generator(args.seed, i), args.batch_size, args.length,
            cond=put(cond), audio_ref=put(ref) if needs_ref else None,
            power_weight=args.power_weight, rms_weight=args.rms_weight,
            teacher_smooth=args.teacher_smooth)
        if (i + 1) % args.log_interval == 0 or i == step0:
            msg = f"step {i + 1}: loss {float(loss):.4f} kl {float(aux['kl']):.4f}"
            if "power" in aux:
                msg += f" power {float(aux['power']):.4f}"
            msg += f" rms {float(aux['rms']):.3f}"
            msg += f" ({(time.time() - t0) / (i - step0 + 1):.3f} s/step)"
            print(msg, flush=True)
        if (i + 1) % args.save_interval == 0:
            path = save(i + 1)
    step = step0 + args.steps
    if args.steps:
        path = save(step)
        print(f"saved {path}")

    wav = None
    if args.generate:
        t0 = time.time()
        gen_cond = None
        if scfg.cond_channels and cond_iter is not None:
            # a conditioned student: copy-synthesis of a real window's mel
            # timeline
            _, rows = next(cond_iter)
            n = min(args.generate, rows.shape[1])
            gen_cond = put(np.broadcast_to(rows[:1, :n],
                                           (args.streams, n, rows.shape[2])))
            args.generate = n
        wav = student_generate(params, scfg,
                               torch.Generator().manual_seed(args.seed),
                               args.generate, num_streams=args.streams,
                               cond=gen_cond, device=dev).cpu().numpy()
        dt = time.time() - t0
        print(f"generated {wav.size} samples in {dt:.3f}s "
              f"({wav.size / dt:,.0f} samples/s, one parallel pass)")
        if args.wav_out:
            from ..data.audio_io import write_wav

            write_wav(args.wav_out, wav[0], 16000)
            print(f"wrote {args.wav_out}")
    return {"params": params, "scfg": scfg, "step": step, "path": path,
            "wav": wav}


if __name__ == "__main__":
    main()
