"""Log-mel features and conditioning upsamplers for the mel-conditioned
vocoder.

The counterpart of the JAX package's ``ops/mel.py``: the numpy parts
(filterbank, log-mel spectrogram, host interpolation) are copied, the
device parts are rewritten in PyTorch. Frames ``(..., F, M)`` become
sample-rate conditioning rows ``(..., length, M)`` with frame i centred at
sample ``i * hop``: by linear interpolation (:func:`upsample_frames`), by
the model's learnable transposed-conv stack (:func:`upsample_frames_conv`)
or, in the serving pool, window by window (:func:`expand_frames_window`).
The phase-scale upsampler (:func:`upsample_frames_phase`, the
PytorchWaveNetVocoder's ``ConvTranspose2d(1, 1, (1, hop), stride (1,
hop))``) instead holds frame i over samples ``[i * hop, (i + 1) * hop)``,
each row the frame times its phase's scale plus one bias.

The products of the learnable stack sum over the M input channels in a
fixed order (one channel after the other), so a row's value depends only
on its inputs, never on how many rows a call expands: the pool's windowed
expansion equals a one-shot expansion bitwise on every device, and no
TF32 or library GEMM takes part.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(num_mels: int = 80, n_fft: int = 1024,
                   sampling_rate: int = 16000, fmin: float = 0.0,
                   fmax: float | None = None) -> np.ndarray:
    """Triangular mel filterbank ``(n_fft//2 + 1, num_mels)`` (HTK mel
    scale, no area normalisation)."""
    if fmax is None:
        fmax = sampling_rate / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sampling_rate / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), num_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fb = np.zeros((n_bins, num_mels), np.float32)
    for m in range(num_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


@functools.lru_cache(maxsize=8)
def _hann_window(n_fft: int) -> np.ndarray:
    return np.hanning(n_fft + 1)[:-1].astype(np.float32)


def log_mel_spectrogram(wav: np.ndarray, num_mels: int = 80,
                        n_fft: int = 1024, hop_length: int = 256,
                        sampling_rate: int = 16000,
                        eps: float = 1e-5) -> np.ndarray:
    """Waveform ``(..., T)`` -> log-mel frames ``(..., 1 + T // hop,
    num_mels)`` on the host. Reflect-padded by ``n_fft // 2`` so frame i is
    centred on sample ``i * hop``; leading axes are kept."""
    wav = np.asarray(wav, np.float32)
    pad = n_fft // 2
    pad_width = [(0, 0)] * (wav.ndim - 1) + [(pad, pad)]
    x = np.pad(wav, pad_width, mode="reflect")
    n_frames = 1 + (x.shape[-1] - n_fft) // hop_length
    idx = np.arange(n_fft)[None, :] + hop_length * np.arange(n_frames)[:, None]
    frames = x[..., idx] * _hann_window(n_fft)  # (..., n_frames, n_fft)
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2  # power
    mel = spec @ mel_filterbank(num_mels, n_fft, sampling_rate)
    return np.log(mel + eps).astype(np.float32)


def _upsample_index_np(F: int, hop_length: int, length: int):
    t = np.arange(length, dtype=np.float32) / hop_length
    i0 = np.clip(np.floor(t).astype(np.int32), 0, F - 1)
    i1 = np.clip(i0 + 1, 0, F - 1)
    w = (t - i0.astype(np.float32))[..., None]
    return i0, i1, w


def upsample_frames_np(frames: np.ndarray, hop_length: int,
                       length: int) -> np.ndarray:
    """Host (numpy) linear interpolation of frames ``(..., F, M)`` to
    ``(..., length, M)``."""
    frames = np.asarray(frames, np.float32)
    lead = frames.shape[:-2]
    F, M = frames.shape[-2:]
    i0, i1, w = _upsample_index_np(F, hop_length, length)
    flat = frames.reshape((-1, F, M))
    a = flat[:, i0, :]
    b = flat[:, i1, :]
    out = a + (b - a) * np.ascontiguousarray(w)
    return out.reshape(lead + (length, M))


def upsample_frames(frames: torch.Tensor, hop_length: int,
                    length: int) -> torch.Tensor:
    """Linear interpolation of frames ``(..., F, M)`` to ``(..., length,
    M)`` on the frames' device: row t blends frames ``floor(t / hop)`` and
    the next (clamped at the last) with weight ``t / hop - floor``."""
    F, dev = frames.shape[-2], frames.device
    t = torch.arange(length, dtype=torch.float32, device=dev) / hop_length
    i0 = torch.clamp(torch.floor(t).to(torch.long), 0, F - 1)
    i1 = torch.clamp(i0 + 1, 0, F - 1)
    w = (t - i0.to(torch.float32))[:, None]
    a = frames.index_select(-2, i0)
    b = frames.index_select(-2, i1)
    return a * (1.0 - w) + b * w


def _stage(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One transposed-conv stage: ``y[..., f, j, :] = x[f] @ w[0, j] +
    x[min(f+1, F-1)] @ w[1, j]`` with ``w`` ``(2, r, M, M)``; each product
    sums its M input channels one after the other."""
    nxt = torch.cat([x[..., 1:, :], x[..., -1:, :]], dim=-2)
    M = x.shape[-1]

    def prod(v, wk):  # (..., F, M) x (r, M, M) -> (..., F, r, M)
        acc = v[..., :, None, 0:1] * wk[:, 0, :]
        for m in range(1, M):
            acc = acc + v[..., :, None, m:m + 1] * wk[:, m, :]
        return acc

    y = prod(x, w[0]) + prod(nxt, w[1])
    return y.reshape(x.shape[:-2] + (x.shape[-2] * w.shape[1], M))


def upsample_frames_conv(up_params: dict, frames: torch.Tensor,
                         factors: tuple[int, ...],
                         length: int) -> torch.Tensor:
    """The learnable transposed-conv upsampler: frames ``(..., F, M)`` ->
    ``(..., length, M)`` through one stage per factor (stage i of stride
    ``r = factors[i]`` mixes each frame with the next through ``w =
    up_params[f"s{i}"]`` of shape ``(2, r, M, M)``). With
    :func:`linear_init_upsampler` weights it reproduces
    :func:`upsample_frames`. Raises when the stack yields fewer than
    ``length`` rows."""
    x = frames
    for i, _ in enumerate(factors):
        x = _stage(x, up_params[f"s{i}"])
    if x.shape[-2] < length:
        raise ValueError(
            f"upsampled cond has {x.shape[-2]} rows "
            f"({frames.shape[-2]} frames x stride {factors}) but {length} "
            "samples were requested; provide more frames or larger factors")
    return x[..., :length, :]


def upsample_frames_phase(up_params: dict, frames: torch.Tensor,
                          hop_length: int, length: int) -> torch.Tensor:
    """The phase-scale upsampler: row t of ``(..., length, M)`` is ``frames[
    ..., min(t // hop, F - 1), :] * w[t % hop] + b`` with ``w =
    up_params["w"]`` ``(hop,)`` and ``b = up_params["b"]`` ``(1,)`` (the
    last frame held past the timeline's end); a product and a sum a
    value, so any window of rows is bitwise the same."""
    dev = frames.device
    t = torch.arange(length, dtype=torch.long, device=dev)
    i = torch.clamp(torch.div(t, hop_length, rounding_mode="floor"),
                    max=frames.shape[-2] - 1)
    scale = up_params["w"].to(device=dev, dtype=torch.float32)[
        t % hop_length][:, None]
    return frames.index_select(-2, i) * scale + up_params["b"].to(
        device=dev, dtype=torch.float32)


def frames_window_len(count: int, hop_length: int,
                      factors: tuple[int, ...] = ()) -> int:
    """Frame-slab length that :func:`expand_frames_window` needs to expand
    ``count`` rows from any in-frame phase: the two bracketing frames of a
    row (or one frame per conv stage) plus a guard frame, so the conv
    stack's clamp at the slab's end never reaches a returned row."""
    return count // hop_length + 3 + len(factors)


def expand_frames_window(params, frames: torch.Tensor, hop_length: int,
                         phase: torch.Tensor, count: int,
                         factors: tuple[int, ...] = (),
                         phase_scale: bool = False) -> torch.Tensor:
    """Expand a per-lane frame slab to ``count`` sample-rate rows, bitwise
    the same for every chunking of a timeline: the interpolation weight of
    global row t comes from the integer ``t mod hop`` (one f32 division of
    the same operands), never from a float ``t / hop``, and the conv
    stack's products have a fixed order (module docstring).

    ``frames``: ``(lanes, Fs, M)``, lane l's slab starting at its timeline
    frame ``off_l // hop``, the last frame replicated past the timeline's
    end (a one-shot reference expansion extends its frames by
    ``len(factors) + 1`` replicated rows the same way). ``phase``:
    ``(lanes,)`` integer ``off_l mod hop``. ``factors``: the learnable
    stages (``params["cond_up"]``), or ``()`` for linear interpolation.
    ``phase_scale``: the phase-scale upsampler of ``params["cond_up"]``
    (:func:`upsample_frames_phase`) instead. Returns ``(lanes, count, M)``
    f32."""
    dev = frames.device
    j = (phase.to(device=dev, dtype=torch.long)[:, None]
         + torch.arange(count, dtype=torch.long, device=dev)[None])
    M = frames.shape[-1]
    if phase_scale:
        up = params["cond_up"]
        i0 = torch.clamp(torch.div(j, hop_length, rounding_mode="floor"),
                         max=frames.shape[1] - 1)
        rows = torch.gather(frames, 1, i0[..., None].expand(-1, -1, M))
        scale = up["w"].to(device=dev, dtype=torch.float32)[
            j % hop_length][..., None]
        return rows * scale + up["b"].to(device=dev, dtype=torch.float32)
    if factors:
        x = frames
        for i, _ in enumerate(factors):
            x = _stage(x, params["cond_up"][f"s{i}"])
        return torch.gather(x, 1, j[..., None].expand(-1, -1, M))
    Fs = frames.shape[1]
    i0 = torch.clamp(torch.div(j, hop_length, rounding_mode="floor"),
                     max=Fs - 1)
    w = (j % hop_length).to(torch.float32)[..., None] / hop_length
    a = torch.gather(frames, 1, i0[..., None].expand(-1, -1, M))
    b = torch.gather(frames, 1, torch.clamp(i0 + 1, max=Fs - 1)[..., None]
                     .expand(-1, -1, M))
    return a * (1.0 - w) + b * w


def linear_init_upsampler(factors: tuple[int, ...], channels: int,
                          dtype=np.float32) -> dict:
    """Weights that make :func:`upsample_frames_conv` linear interpolation:
    stage ``r`` mixes ``x[f]`` with weight ``1 - j/r`` and ``x[f+1]`` with
    ``j/r`` through identity channel maps (numpy arrays)."""
    up = {}
    eye = np.eye(channels, dtype=dtype)
    for i, r in enumerate(factors):
        t = (np.arange(r, dtype=dtype) / r)[:, None, None]
        up[f"s{i}"] = np.stack([(1.0 - t) * eye, t * eye])  # (2, r, M, M)
    return up
