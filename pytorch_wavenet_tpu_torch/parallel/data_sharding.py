"""Each rank's block of a global shuffled batch stream: the JAX package's
``parallel/data_sharding.py``.

Every rank walks the same seeded permutation (the order of
:class:`~pytorch_wavenet_tpu_torch.data.dataset.BatchIterator` for the
seed) and takes its data index's block of each global batch.

Departure from the JAX package: the local batch is ``global / data``, not
``global / process_count``. In the JAX package one process holds several
devices and assembles a global array from them; here one rank is one
device, and the ranks of one model group (the same data index) hold the
same block.
"""

from __future__ import annotations

from ..data.dataset import BatchIterator, PrefetchBatchIterator
from .sharding import batch_sharding


class ShardedBatchIterator(PrefetchBatchIterator):
    """This rank's block ``(x, y[, cond])`` of every global batch of
    ``global_batch_size`` items, as numpy (``skip_batches`` skips whole
    global batches, for an exact resume). ``num_workers > 0`` gathers the
    blocks ahead on a thread pool, in the same order. Raises when the
    global batch does not divide over the mesh's data axis."""

    def __init__(self, dataset, global_batch_size: int, mesh,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 skip_batches: int = 0, num_workers: int = 0):
        self.rows = batch_sharding(mesh, global_batch_size)
        super().__init__(dataset, global_batch_size, shuffle=shuffle,
                         seed=seed, drop_last=drop_last,
                         skip_batches=skip_batches, num_workers=num_workers)
        self.global_batch_size = global_batch_size
        self.local_batch_size = self.rows.stop - self.rows.start
        self.mesh = mesh

    def _batch_indices(self):
        return [idxs[self.rows] for idxs in super()._batch_indices()]

    def __iter__(self):
        if self.num_workers > 0:
            return super().__iter__()
        return BatchIterator.__iter__(self)
