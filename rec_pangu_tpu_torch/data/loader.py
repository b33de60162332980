"""Fixed-shape batching over fused numpy arrays.

The dataset is already encoded, so a batch is one fancy-index of each array;
batches are dicts of numpy arrays, uploaded by the trainer or scorer.
``drop_last=False`` keeps every row (all rows contribute to metrics).
A dataset with a ``resample(epoch)`` method (the sequence datasets) gets
it called at the start of every iteration, with the epoch counted here.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class DataLoader:
    def __init__(self, dataset, batch_size: int = 512 * 3, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 1029,
                 shard_rank: int = 0, num_shards: int = 1):
        """``shard_rank``/``num_shards``: each process iterates its strided
        slice of the rows, with the same shuffle order on every process."""
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.shard_rank = int(shard_rank)
        self.num_shards = int(num_shards)
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    def _shard_size(self) -> int:
        return len(range(self.shard_rank, len(self.dataset), self.num_shards))

    def __len__(self) -> int:
        n = self._shard_size()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if hasattr(self.dataset, "resample"):
            self.dataset.resample(self._epoch)
        self._epoch += 1
        arrays = self.dataset.arrays
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        if self.num_shards > 1:
            idx = idx[self.shard_rank::self.num_shards]
        n = len(idx)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            sel = idx[start:start + self.batch_size]
            yield {k: v[sel] for k, v in arrays.items()}
