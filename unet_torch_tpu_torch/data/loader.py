"""Host-side batching loader with background prefetch.

The reference wraps datasets in torch DataLoader with in-process loading (its
`num_workers: 20` config value is read but never passed — reference
train.py:155,330-334).  Ours is a minimal numpy loader with a real prefetch
thread, so cv2 decode / augmentation overlaps device compute: while the device runs
step N, the host assembles batch N+1.

Batches are stacked numpy arrays (pytrees of them); the device transfer happens
in the trainer, one host->device crossing per step.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence

import numpy as np


def _stack(samples: Sequence):
    """Stack a list of per-sample pytrees (tuples/dicts/arrays) leaf-wise."""
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([s[i] for s in samples])
                           for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack([s[k] for s in samples]) for k in first}
    return np.stack([np.asarray(s) for s in samples], axis=0)


class NumpyLoader:
    """Iterable over batches of a map-style dataset.

    dataset: object with __len__ and __getitem__ returning numpy pytrees.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False, prefetch: int = 2,
                 collate_fn=None, num_workers: int = 0,
                 shard_index: int = 0, num_shards: int = 1):
        """``num_shards > 1`` = multi-process data parallelism: every process
        draws the SAME permutation (same seed) and keeps the
        ``shard_index``-strided subset, so the union over processes is one
        epoch with no overlap; ``batch_size`` is per-process."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.collate_fn = collate_fn or _stack
        self.num_workers = num_workers
        self.shard_index = shard_index
        self.num_shards = num_shards
        self._rng = np.random.RandomState(seed)

    def _fetch(self, chunk, executor=None):
        if executor is not None:
            samples = list(executor.map(self.dataset.__getitem__,
                                        [int(j) for j in chunk]))
        else:
            samples = [self.dataset[int(j)] for j in chunk]
        return self.collate_fn(samples)

    def __len__(self):
        n = len(self.dataset) // self.num_shards if self.num_shards > 1 \
            else len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        if self.num_shards > 1:
            # equal-length shards (truncate the remainder) so all processes
            # run the same number of steps — collectives stay in lock-step
            per = len(idx) // self.num_shards
            idx = idx[self.shard_index::self.num_shards][:per]
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i:i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield chunk

    def __iter__(self) -> Iterator:
        executor = None
        if self.num_workers and self.num_workers > 1:
            # sample-level thread pool: cv2/scipy/np release the GIL in their
            # hot loops, so threads overlap decode work (the reference reads
            # `num_workers: 20` from config but never passes it —
            # train.py:155,330-334; here it is honoured)
            from concurrent.futures import ThreadPoolExecutor

            executor = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            if self.prefetch <= 0:
                for chunk in self._index_batches():
                    yield self._fetch(chunk, executor)
                return

            q: queue.Queue = queue.Queue(maxsize=self.prefetch)
            sentinel = object()
            error = []

            def producer():
                try:
                    for chunk in self._index_batches():
                        q.put(self._fetch(chunk, executor))
                except BaseException as e:  # surface errors to the consumer
                    error.append(e)
                finally:
                    q.put(sentinel)

            t = threading.Thread(target=producer, daemon=True)
            t.start()
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
            t.join()
            if error:
                raise error[0]
        finally:
            if executor is not None:
                executor.shutdown(wait=False)
