"""Mel-conditioned vocoder dataset: the JAX package's
``data/mel_dataset.py`` on numpy alone.

Each batch of a :class:`WaveNetDataset` also carries the log-mel features
of its (dequantized) input windows, the training input of the ``vocoder``
preset. The window audio is decoded by the native codec
(``data/native.py``), as in the JAX package; without a C++ compiler by the
numpy codec (a few f32 ulps apart, about 2e-7 of the waveform).
"""

from __future__ import annotations

import numpy as np

from ..ops.mel import log_mel_spectrogram, upsample_frames_np
from . import native
from .dataset import WaveNetDataset


class MelWaveNetDataset(WaveNetDataset):
    """Batches are ``(x (B, item_length) int32, y (B, target_length) int32,
    cond float32)`` where cond is mel frames ``(B, F, num_mels)`` by default
    (``device_upsample``: the trainer expands them to per-sample rows on
    the device) or upsampled rows ``(B, item_length, num_mels)`` with
    ``device_upsample=False``."""

    def __init__(self, *args, num_mels: int = 80, n_fft: int = 1024,
                 hop_length: int = 256, device_upsample: bool = True,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.num_mels = num_mels
        self.n_fft = n_fft
        self.hop_length = hop_length
        # frames travel to the device (hop_length times fewer bytes than
        # per-sample rows) and the train step expands them there
        self.device_upsample = device_upsample

    def _mel_for_windows(self, x: np.ndarray) -> np.ndarray:
        """``(B, T)`` int classes -> log-mel frames ``(B, F, num_mels)``
        (or rows ``(B, T, num_mels)`` without ``device_upsample``), the
        whole batch in one numpy pass."""
        T = x.shape[1]
        wav = native.mu_law_dequantize(x.astype(np.uint8), self.classes)
        frames = log_mel_spectrogram(
            wav, num_mels=self.num_mels, n_fft=self.n_fft,
            hop_length=self.hop_length,
            sampling_rate=self.sampling_rate or 16000)
        if self.device_upsample:
            return frames
        return upsample_frames_np(frames, self.hop_length, T)

    def get_batch(self, idxs):
        x, y = super().get_batch(idxs)
        return x, y, self._mel_for_windows(x)

    def __getitem__(self, idx):
        x, y = super().__getitem__(idx)
        cond = self._mel_for_windows(x[None, :].astype(np.int32))[0]
        return x, y, cond
