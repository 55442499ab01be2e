"""Window dataset over mu-law-quantized audio: the JAX package's
``data/dataset.py`` on numpy alone.

The same featurization (a directory of audio files becomes one ``.npz`` of
per-file uint8 class arrays on first use), the same index math
(``sample_index``, ``__len__``: every ``test_stride``-th window is the test
split, train windows creep one byte per ``test_stride - 1`` items), the
same ``.flat`` stream cache beside the npz, and the same batch order for a
seed (``default_rng(seed).permutation``, ``skip_batches`` for resume).
As in the JAX package, files are quantized and batches gathered by the
native C++ codec (``data/native.py``, built with ``g++`` at first use),
so both packages write the same ``dataset.npz`` from the same audio;
without a compiler the numpy paths run (the same windows; the quantizer
may differ by one class, rarely).
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..ops.mulaw import quantize_data
from . import native
from .audio_io import list_all_audio_files, load_audio, normalize


class WaveNetDataset:
    """Item ``i`` is the ``item_length + 1`` consecutive classes starting at
    ``sample_index(i)`` of the flat stream: the first ``item_length`` are
    the input, the last ``target_length`` the targets."""

    def __init__(self, dataset_file: str, item_length: int,
                 target_length: int, file_location: str | None = None,
                 classes: int = 256, sampling_rate: int = 16000,
                 mono: bool = True, normalize: bool = False,
                 dtype=np.uint8, train: bool = True, test_stride: int = 100):
        self.dataset_file = dataset_file
        self._item_length = item_length
        self._test_stride = test_stride
        self.target_length = target_length
        self.classes = classes
        self.sampling_rate = sampling_rate
        self.mono = mono
        self.normalize = normalize
        self.dtype = dtype
        if not os.path.isfile(dataset_file):
            if file_location is None:
                raise ValueError(f"{dataset_file} does not exist and no "
                                 "file_location was given to build it from")
            self.create_dataset(file_location, dataset_file)
        self.data = np.load(self.dataset_file, mmap_mode="r")
        self.start_samples: list[int] = [0]
        self._length = 0
        self.calculate_length()
        self.train = train
        self._flat: np.ndarray | None = None

    # ------------------------------------------------------------ featurize

    def _featurize_one(self, file: str) -> np.ndarray:
        data, _ = load_audio(file, sampling_rate=self.sampling_rate,
                             mono=self.mono)
        if self.normalize:
            data = normalize(data)
        if self.dtype == np.uint8 and native.available():
            return native.mu_law_quantize(data, self.classes)
        return quantize_data(data, self.classes).astype(self.dtype)

    def create_dataset(self, location: str, out_file: str,
                       num_workers: int = 8):
        """mu-law quantize every audio file under ``location`` into one npz,
        files featurized concurrently."""
        print("create dataset from audio files at", location)
        self.dataset_file = out_file
        files = list_all_audio_files(location)
        with ThreadPoolExecutor(max_workers=num_workers) as ex:
            processed = list(ex.map(self._featurize_one, files))
        print(f"  processed {len(files)} files")
        np.savez(out_file, *processed)

    # ------------------------------------------------------------- indexing

    def calculate_length(self):
        """Per-file offsets into the stream and the number of windows: one
        per ``target_length`` bytes after the warm-up prefix."""
        sizes = [len(self.data["arr_" + str(i)])
                 for i in range(len(self.data.files))]
        self.start_samples = [0] + list(np.cumsum(sizes))
        total = self.start_samples[-1]
        usable = total - (self._item_length - (self.target_length - 1)) - 1
        self._length = usable // self.target_length

    def set_item_length(self, length):
        self._item_length = length
        self.calculate_length()

    def sample_index(self, idx: int) -> int:
        """Split-local item index -> byte offset of its window (the JAX
        package's arithmetic, odd as it is)."""
        if self._test_stride < 2:
            return idx * self.target_length
        if self.train:
            return idx * self.target_length + idx // (self._test_stride - 1)
        return self._test_stride * (idx + 1) - 1

    @property
    def flat_stream(self) -> np.ndarray:
        """The concatenated class stream, memory-mapped from a one-time
        cache next to the npz."""
        if self._flat is None:
            cache = self.dataset_file + ".flat"
            total = self.start_samples[-1]
            if not os.path.isfile(cache) or os.path.getsize(cache) != total:
                tmp = cache + f".tmp.{os.getpid()}"
                with open(tmp, "wb") as f:
                    for i in range(len(self.data.files)):
                        np.asarray(self.data["arr_" + str(i)],
                                   np.uint8).tofile(f)
                os.replace(tmp, cache)
            self._flat = np.memmap(cache, np.uint8, mode="r", shape=(total,))
        return self._flat

    def get_batch(self, idxs) -> tuple[np.ndarray, np.ndarray]:
        """int32 ``(B, item_length)`` inputs and ``(B, target_length)``
        targets of the items ``idxs``."""
        starts = np.asarray([self.sample_index(int(i)) for i in idxs],
                            np.int64)
        return native.gather_windows(self.flat_stream, starts,
                                     self._item_length, self.target_length)

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        """``(input (item_length,), target (target_length,))`` int64."""
        start = self.sample_index(idx)
        stop = start + self._item_length + 1
        stream = self.flat_stream
        if stop > stream.shape[0]:
            raise IndexError(f"window [{start}, {stop}) exceeds the "
                             f"{stream.shape[0]}-byte stream")
        window = np.asarray(stream[start:stop], dtype=np.int64)
        return window[:self._item_length], window[-self.target_length:]

    def __len__(self) -> int:
        n_test = self._length // self._test_stride
        return self._length - n_test if self.train else n_test


class BatchIterator:
    """Shuffled mini-batches of a :class:`WaveNetDataset`, in the JAX
    package's order for a seed."""

    def __init__(self, dataset: WaveNetDataset, batch_size: int,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 skip_batches: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.skip_batches = skip_batches
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        total = (n // self.batch_size if self.drop_last
                 else math.ceil(n / self.batch_size))
        return max(total - self.skip_batches, 0)

    def _batch_indices(self):
        n = len(self.dataset)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        out = []
        for i in range(0, n, self.batch_size):
            idxs = order[i:i + self.batch_size]
            if self.drop_last and len(idxs) < self.batch_size:
                break
            out.append(idxs)
        return out[self.skip_batches:]

    def __iter__(self):
        for idxs in self._batch_indices():
            yield self.dataset.get_batch(idxs)


class PrefetchBatchIterator(BatchIterator):
    """A :class:`BatchIterator` whose batches are gathered on a thread pool
    ahead of use, at most ``depth`` in flight, in the same order."""

    def __init__(self, *args, num_workers: int = 4, depth: int = 8,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.num_workers = num_workers
        self.depth = max(depth, 1)

    def __iter__(self):
        batches = self._batch_indices()
        if not batches:
            return
        self.dataset.flat_stream  # build the cache before the workers start
        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            pending = []
            it = iter(batches)
            for idxs in it:
                pending.append(ex.submit(self.dataset.get_batch, idxs))
                if len(pending) >= self.depth:
                    break
            for idxs in it:
                yield pending.pop(0).result()
                pending.append(ex.submit(self.dataset.get_batch, idxs))
            for fut in pending:
                yield fut.result()
