"""Host-side data loader: sharding, epoch reshuffle, background prefetch.

Counterpart of ``parallelwavegan_tpu/datasets/loader.py``; this package
keeps its own copy. Each shard iterates a disjoint part of a permutation
that is reshuffled every epoch from a seeded generator, collates fixed-shape
numpy batches on a worker thread, and keeps a small queue so that device
steps overlap the host's cropping. Spans (``utils/tracing.py``):
``data.collate`` around each batch's collation (the worker's thread; its
request is the batch's number in the epoch) and ``data.wait`` around the
consumer's wait for the queue.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np

from parallelwavegan_torch.utils import tracing


class DataLoader:
    def __init__(
        self,
        dataset,
        collate_fn: Callable,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            idx = np.random.default_rng(self.seed + self.epoch).permutation(n)
        else:
            idx = np.arange(n)
        # pad so that every shard sees the same number of samples, and a
        # tiny dataset still fills at least one batch per shard
        per_shard = max(-(-n // self.num_shards), self.batch_size)
        total = per_shard * self.num_shards
        if total > n:
            idx = np.concatenate(
                [idx, np.tile(idx, -(-total // n))[: total - n]]
            )
        return idx[self.shard_index :: self.num_shards]

    def _num_batches(self, n_items: int) -> int:
        if self.drop_last:
            return n_items // self.batch_size
        return -(-n_items // self.batch_size)

    def __len__(self) -> int:
        return self._num_batches(len(self._indices()))

    def _batches(self) -> Iterator:
        idx = self._indices()
        for b in range(self._num_batches(len(idx))):
            items = [
                self.dataset[int(i)]
                for i in idx[b * self.batch_size : (b + 1) * self.batch_size]
            ]
            with tracing.span("data.collate", b):
                batch = self.collate_fn(items)
            yield batch

    def __iter__(self) -> Iterator:
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error: list = []

        def worker():
            try:
                for batch in self._batches():
                    q.put(batch)
            except BaseException as e:  # handed to the consumer
                error.append(e)
            finally:
                q.put(sentinel)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            with tracing.span("data.wait"):
                item = q.get()
            if item is sentinel:
                break
            yield item
        if error:
            raise error[0]
