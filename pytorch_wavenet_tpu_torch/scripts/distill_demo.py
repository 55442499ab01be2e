"""End-to-end distillation quality demo: teacher -> IAF student, measured
(the JAX package's ``scripts/distill_demo.py``).

Runs the Parallel-WaveNet pipeline on seeded synthetic audio:

1. synthesize a deterministic "melody" (a seeded pentatonic random walk
   over three harmonics), 80 % for training, 20 % held out;
2. train a demo autoregressive teacher (9x2 layers, width 32, skip 512,
   end 256, output 1024, bias; ``tiny`` under ``--smoke``) through
   ``training/trainer.py::train_step``: the trunk through the kernels
   K2/K3 on the card;
3. distill an IAF student against the frozen teacher
   (``training/distill.py::distill_step``: probability density
   distillation, power and log-RMS terms; the teacher scored through K2);
4. evaluate with the JAX script's metrics:
   * KL trajectory: the mean teacher||student bin-KL over the first and the
     last ``--eval-steps`` distillation steps;
   * the RMS of student draws against the held-out data's;
   * log-mel L2: time-averaged log-mel spectra of student draws against
     held-out data, with the student at init and the teacher's own
     rollouts scored the same way; in ``--mode vocoder`` both models
     synthesize from the held-out segment's mel timeline and the metric
     is per-frame log-mel L2 against that target.

The teacher's rollouts run on the generation kernels by the generate
CLI's rule (``generate_cli.k1_runs``): K1 for up to 8 streams that fit a
cluster, else K4; on the CPU their plain versions. ``--out-dir`` writes
the teacher and the student snapshots (the JAX package's checkpoint
format; the student's with its ``iaf_config``), a student wav and the
metrics JSON. ``--teacher-ckpt`` reuses a demo teacher saved by either
package.

  python -m pytorch_wavenet_tpu_torch.scripts.distill_demo --mode uncond --json
  python -m pytorch_wavenet_tpu_torch.scripts.distill_demo --mode vocoder \\
      --smoke --teacher-steps 30 --distill-steps 30 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--mode", choices=("uncond", "vocoder"), default="uncond")
    p.add_argument("--seconds", type=float, default=60.0)
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--teacher-steps", type=int, default=4000)
    p.add_argument("--distill-steps", type=int, default=4000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--distill-batch", type=int, default=4)
    p.add_argument("--distill-length", type=int, default=4000)
    p.add_argument("--power-weight", type=float, default=0.03,
                   help="power-loss weight")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--distill-lr", type=float, default=3e-4)
    p.add_argument("--distill-lr-schedule", default="constant",
                   choices=("constant", "cosine"),
                   help="cosine decays to 0.1x over --distill-steps")
    p.add_argument("--rms-weight", type=float, default=None,
                   help="log-RMS matching weight (default 3.0 uncond, 6.0 "
                        "vocoder, the JAX script's)")
    p.add_argument("--teacher-smooth", type=float, default=1e-3,
                   help="teacher label smoothing during distillation")
    p.add_argument("--eval-steps", type=int, default=50,
                   help="steps averaged for the start and end KL readings")
    p.add_argument("--eval-samples", type=int, default=32000,
                   help="per-stream evaluation rollout length")
    p.add_argument("--eval-streams", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--student-flows", type=int, default=None)
    p.add_argument("--student-width", type=int, default=None)
    p.add_argument("--student-layers", type=int, default=None)
    p.add_argument("--student-blocks", type=int, default=None)
    p.add_argument("--rms-per-item", action="store_true",
                   help="pin each draw's level to its own reference "
                        "window's (always on in vocoder mode)")
    p.add_argument("--teacher-width", type=int, default=None,
                   help="demo teacher residual/dilation channels "
                        "(default 32)")
    p.add_argument("--teacher-ckpt", default=None,
                   help="reuse a saved demo teacher instead of training")
    p.add_argument("--out-dir", default=None,
                   help="save the snapshots, a student wav and the metrics")
    p.add_argument("--json", action="store_true")
    p.add_argument("--smoke", action="store_true",
                   help="tiny model sizes (the CPU test path)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    return p.parse_args(argv)


def make_melody(seconds: float, sr: int, seed: int) -> np.ndarray:
    """Seeded pentatonic random walk, three harmonics, per-note envelope."""
    rng = np.random.default_rng(seed)
    scale = 220.0 * 2.0 ** (np.array([0, 2, 4, 7, 9]) / 12.0)
    note_len = sr // 4
    n_notes = int(seconds * sr) // note_len + 1
    idx = np.cumsum(rng.integers(-2, 3, n_notes)) % len(scale)
    f0 = np.repeat(scale[idx], note_len)[: int(seconds * sr)]
    phase = 2 * np.pi * np.cumsum(f0) / sr
    env = 0.4 + 0.2 * np.sin(2 * np.pi * np.arange(len(f0)) / note_len)
    wav = env * (np.sin(phase) + 0.5 * np.sin(2 * phase)
                 + 0.25 * np.sin(3 * phase)) / 1.75
    return wav.astype(np.float32)


def mel_l2(a_mel: np.ndarray, b_mel: np.ndarray) -> float:
    """Mean squared distance between log-mel frames (same shape)."""
    n = min(a_mel.shape[-2], b_mel.shape[-2])
    return float(np.mean((a_mel[..., :n, :] - b_mel[..., :n, :]) ** 2))


def configs(args):
    """(teacher config, student config) of the JAX script: the teacher
    without ``trunk_kernel`` (the config its snapshot records)."""
    from .. import IAFConfig, WaveNetConfig, get_config

    n_mels = 16 if args.smoke else 32
    cond = n_mels if args.mode == "vocoder" else 0
    if args.smoke:
        tcfg = get_config("tiny", output_length=64, cond_channels=cond)
        scfg = IAFConfig(flows=2, layers=3, blocks=1, residual_channels=8,
                         dilation_channels=8, skip_channels=8,
                         end_channels=8, cond_channels=cond)
        return tcfg, scfg
    tw = args.teacher_width or 32
    tcfg = WaveNetConfig(
        layers=9, blocks=2, dilation_channels=tw, residual_channels=tw,
        skip_channels=512, end_channels=256, output_length=1024, bias=True,
        cond_channels=cond)
    w = args.student_width or 64
    scfg = IAFConfig(flows=args.student_flows or 4,
                     layers=args.student_layers or 10,
                     blocks=args.student_blocks or 1, residual_channels=w,
                     dilation_channels=w, skip_channels=w, end_channels=w,
                     cond_channels=cond)
    return tcfg, scfg


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone(v) for v in tree)
    return tree.detach().clone()


def teacher_rollout(params, cfg, seed, num_samples, prime, cond, dev):
    """The teacher's rollout at temperature 1 on the generate CLI's path:
    K1 (``fuse_res``) where it takes the streams, else K4 (``fuse_res``,
    ``skip_slab`` at a skip width of 256 or more)."""
    from ..generate_cli import k1_runs
    from ..ops.cuda.gen_kernel import generate_fast_fused
    from ..ops.cuda.gen_kernel_hbm import generate_fast_batched

    streams = prime.shape[0]
    if k1_runs(cfg, streams, True, cond is not None):
        wav, _ = generate_fast_fused(params, cfg, seed, num_samples, prime,
                                     temperature=1.0, fuse_res=True,
                                     cond=cond, device=dev)
    else:
        wav, _ = generate_fast_batched(
            params, cfg, seed, num_samples, prime, temperature=1.0,
            fuse_res=True, skip_slab=cfg.skip_channels >= 256, cond=cond,
            device=dev)
    return wav.cpu().numpy()


def main(argv=None) -> dict:
    """Run the demo; returns the metrics (the ``--json`` line)."""
    args = parse_args(argv)
    if args.rms_weight is None:
        args.rms_weight = 6.0 if args.mode == "vocoder" else 3.0
    from .. import init_student, init_wavenet, student_generate
    from ..data.audio_io import write_wav
    from ..device import resolve_device
    from ..models.iaf import student_state_dict
    from ..ops import mel as mel_ops
    from ..ops.mulaw import quantize_data
    from ..training.distill import distill_step
    from ..training.optimizers import lr_schedule, reference_adam
    from ..training.trainer import train_step
    from ..utils.checkpoints import load_checkpoint, save_checkpoint

    dev = resolve_device(args.device)
    t_wall = time.time()
    wav = make_melody(args.seconds, args.sr, args.seed)
    split = int(len(wav) * 0.8)
    train_wav, held_wav = wav[:split], wav[split:]

    n_mels, n_fft, hop = (16, 256, 64) if args.smoke else (32, 512, 64)

    def melspec(w):
        return mel_ops.log_mel_spectrogram(
            w, num_mels=n_mels, n_fft=n_fft, hop_length=hop,
            sampling_rate=args.sr)

    tcfg, scfg = configs(args)
    kcfg = dataclasses.replace(tcfg, trunk_kernel=True)  # K2/K3's path
    rf = tcfg.receptive_field
    print(f"mode={args.mode} teacher rf={rf} "
          f"params={tcfg.parameter_count():,} device={dev.type}", flush=True)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    classes = tcfg.classes
    q = quantize_data(train_wav, classes).astype(np.int32)  # class stream
    cond_full = None
    if args.mode == "vocoder":
        frames = melspec(train_wav)  # (F, n_mels)
        cond_full = mel_ops.upsample_frames_np(
            frames[None], hop, len(train_wav))[0]  # (T, n_mels)

    # ---------------- teacher training (random windows)
    params = init_wavenet(tcfg, torch.Generator().manual_seed(args.seed), dev)
    item, out_len = tcfg.item_length, tcfg.output_length
    rng = np.random.default_rng(args.seed + 1)
    B = args.batch_size
    loss = None
    if args.teacher_ckpt:
        ck = load_checkpoint(args.teacher_ckpt, dev)
        if dataclasses.replace(ck["config"], trunk_kernel=False) != tcfg:
            raise SystemExit(f"--teacher-ckpt config {ck['config']} != demo "
                             f"teacher {tcfg}")
        params = ck["params"]
        # keep the data rng's stream that of the trained path, so the
        # distillation windows match across runs
        for _ in range(args.teacher_steps):
            rng.integers(0, len(q) - item - 1, B)
        args.teacher_steps = 0
        print("teacher: loaded from checkpoint", flush=True)
    tx = reference_adam(args.lr)
    params = {k: {n: t.detach().requires_grad_(True) for n, t in v.items()}
              for k, v in params.items()}
    opt = tx.init(params)
    for step in range(args.teacher_steps):
        starts = rng.integers(0, len(q) - item - 1, B)
        x = np.stack([q[s: s + item] for s in starts])
        y = np.stack([q[s + item - out_len + 1: s + item + 1] for s in starts])
        cond = None
        if cond_full is not None:
            cond = put(np.stack([cond_full[s: s + item] for s in starts]))
        loss, _ = train_step(params, opt, kcfg, tx, put(x), put(y), cond=cond)
        if step % 500 == 0 or step == args.teacher_steps - 1:
            print(f"teacher step {step}: loss {float(loss):.3f}", flush=True)
    teacher_loss = float(loss) if loss is not None else float("nan")
    params = {k: {n: t.detach() for n, t in v.items()}
              for k, v in params.items()}

    # ---------------- distillation
    # amplitude-matched init: Logistic(0, 1) noise (std about 1.81) sits in
    # the mu-law teacher's flat log-probability region
    data_rms = float(np.sqrt(np.mean(train_wav**2)))
    student = init_student(scfg, torch.Generator().manual_seed(args.seed + 2),
                           init_scale=data_rms / 1.8138, device=dev)
    student_init = _clone(student)
    lr = (lr_schedule(args.distill_lr, "cosine",
                      decay_steps=args.distill_steps, min_lr_ratio=0.1)
          if args.distill_lr_schedule == "cosine" else args.distill_lr)
    stx = reference_adam(lr, gradient_clipping=1.0)  # optax's clip, adam
    sopt = stx.init(student_state_dict(student))
    dlen = max(args.distill_length, rf + 257)
    dB = args.distill_batch
    audio_ref = put(np.stack([
        train_wav[s: s + dlen] for s in
        rng.integers(0, len(train_wav) - dlen - 1, dB)]))
    kls, rmss = [], []
    for step in range(args.distill_steps):
        cond = None
        ref_step = audio_ref
        if cond_full is not None:
            # audio_ref rides the same windows as cond, so the per-item
            # rms regulator pins each draw to its own window's level
            starts = rng.integers(0, len(train_wav) - dlen - 1, dB)
            cond = put(np.stack([cond_full[s: s + dlen] for s in starts]))
            ref_step = put(np.stack([train_wav[s: s + dlen]
                                     for s in starts]))
        student, sopt, _, aux = distill_step(
            student, sopt, params, scfg, kcfg, stx,
            torch.Generator().manual_seed((args.seed + 3) * 2**32 + step),
            dB, dlen, cond=cond, audio_ref=ref_step,
            power_weight=args.power_weight, rms_weight=args.rms_weight,
            teacher_smooth=args.teacher_smooth,
            rms_per_item=args.rms_per_item or cond_full is not None)
        kls.append(float(aux["kl"]))
        rmss.append(float(aux["rms"]))
        if step % 500 == 0 or step == args.distill_steps - 1:
            print(f"distill step {step}: kl {kls[-1]:.3f} "
                  f"rms {rmss[-1]:.3f}", flush=True)
    ev = min(args.eval_steps, max(1, len(kls) // 4))
    kl_start = float(np.mean(kls[:ev])) if kls else float("nan")
    kl_end = float(np.mean(kls[-ev:])) if kls else float("nan")

    # ---------------- evaluation
    n_eval = args.eval_samples if not args.smoke else 2048
    streams = args.eval_streams if not args.smoke else 2
    data_rms = float(np.sqrt(np.mean(held_wav**2)))
    eseed = args.seed + 4

    def draw(sp, n, cond=None):
        with torch.no_grad():
            return student_generate(
                sp, scfg, torch.Generator().manual_seed(eseed), n,
                num_streams=streams, cond=cond, device=dev).cpu().numpy()

    if args.mode == "uncond":
        s_wav = draw(student, n_eval)
        t_wav = teacher_rollout(
            params, tcfg, eseed, n_eval,
            np.full((streams, 1), classes // 2, np.int32), None, dev)

        def avg(w):  # distribution level: the time-averaged log-mel
            return melspec(w).mean(axis=-2)

        ref_avg = avg(held_wav)
        logmel_student = float(np.mean((avg(s_wav).mean(0) - ref_avg) ** 2))
        logmel_teacher = float(np.mean((avg(t_wav).mean(0) - ref_avg) ** 2))
        i_wav = draw(student_init, n_eval)
        logmel_init = float(np.mean((avg(i_wav).mean(0) - ref_avg) ** 2))
    else:
        # vocode the held-out mel timeline; score against that target mel
        tgt = held_wav[: n_eval + rf]
        frames = melspec(tgt)
        cond_t = mel_ops.upsample_frames_np(frames[None], hop, len(tgt))[0]
        c1 = put(cond_t)[None]
        # several draws on the same mel timeline: one draw's RMS is too
        # noisy to read the level against
        cS = c1.expand(streams, -1, -1)
        s_wav = draw(student, len(tgt), cS)
        # row t conditions the step consuming input sample t: an rf-primed
        # rollout of len(tgt) - rf samples uses len(tgt) - 1 rows
        t_wav = teacher_rollout(
            params, tcfg, eseed, len(tgt) - rf,
            quantize_data(tgt[:rf], classes)[None].astype(np.int32),
            c1[:, :-1], dev)
        ref_mel = melspec(tgt)
        logmel_student = float(np.mean(
            [mel_l2(melspec(w), ref_mel) for w in s_wav]))
        logmel_teacher = mel_l2(melspec(t_wav[0]), melspec(tgt[rf:]))
        i_wav = draw(student_init, len(tgt), cS)
        logmel_init = float(np.mean(
            [mel_l2(melspec(w), ref_mel) for w in i_wav]))
    student_rms = float(np.sqrt(np.mean(s_wav**2)))

    metrics = {
        "mode": args.mode,
        "teacher_steps": args.teacher_steps,
        "teacher_final_loss": round(teacher_loss, 4),
        "distill_steps": args.distill_steps,
        "kl_start": round(kl_start, 4),
        "kl_end": round(kl_end, 4),
        "data_rms": round(data_rms, 4),
        "student_rms": round(student_rms, 4),
        "rms_ratio": round(student_rms / max(data_rms, 1e-9), 3),
        "logmel_l2_student": round(logmel_student, 4),
        "logmel_l2_init": round(logmel_init, 4),
        "logmel_l2_teacher": round(logmel_teacher, 4),
        "wall_s": round(time.time() - t_wall, 1),
    }
    print(f"KL {kl_start:.3f} -> {kl_end:.3f} | rms ratio "
          f"{metrics['rms_ratio']} | log-mel L2 student "
          f"{logmel_student:.4f} (init {logmel_init:.4f}, "
          f"teacher {logmel_teacher:.4f})", flush=True)
    if args.json:
        print(json.dumps(metrics), flush=True)
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        save_checkpoint(args.out_dir, f"demo_teacher_{args.mode}",
                        args.teacher_steps, params, cfg=tcfg)
        save_checkpoint(
            args.out_dir, f"demo_student_{args.mode}", args.distill_steps,
            student_state_dict(student),
            extra={"iaf_config": dataclasses.asdict(
                dataclasses.replace(scfg, compute_dtype=None))})
        write_wav(os.path.join(args.out_dir, f"student_{args.mode}.wav"),
                  np.clip(s_wav[0], -1, 1), args.sr)
        with open(os.path.join(args.out_dir,
                               f"metrics_{args.mode}.json"), "w") as f:
            json.dump(metrics, f)
    return metrics


if __name__ == "__main__":
    main()
