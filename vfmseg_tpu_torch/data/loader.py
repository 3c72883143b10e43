"""Prefetching data loader.

Port of vfmseg_tpu/data/loader.py: worker threads build shuffled batches
ahead of the training loop and collate them into numpy arrays; the train
step moves them to the device. Batches come out in the order their indices
were drawn, so the order of the samples depends only on the seed.
:meth:`InfiniteLoader.close` stops and joins the workers.

Under data parallelism (``rank`` of ``world``) every rank draws the same
permutation from the seed and builds only its ``batch_size / world`` rows
of each global batch of ``batch_size``: the rank's block of the global
batch's indices.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

from vfmseg_tpu_torch.parallel import mesh


def collate(samples) -> Dict[str, np.ndarray]:
    keys = samples[0].keys()
    return {
        k: np.stack([s[k] for s in samples])
        for k in keys
        if isinstance(samples[0][k], np.ndarray)
    }


class InfiniteLoader:
    """Infinite shuffled batches with background prefetch threads."""

    def __init__(self, dataset, batch_size: int = 2, num_workers: int = 4,
                 seed: int = 0, prefetch: int = 4, rank: int = 0,
                 world: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rows = mesh.shard_rows(batch_size, rank, world)
        self.num_workers = max(num_workers, 1)
        self.rng = np.random.default_rng(seed)
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._index_lock = threading.Lock()
        self._perm: list = []
        self._drawn = 0      # global batches whose indices were drawn
        self._served = 0     # batches handed to the consumer
        self._ready: dict = {}
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(self.num_workers)
        ]
        for t in self._threads:
            t.start()

    def _next_indices(self, n: int):
        """The next global batch's sequence number and ``n`` indices."""
        with self._index_lock:
            out = []
            for _ in range(n):
                if not self._perm:
                    self._perm = list(self.rng.permutation(len(self.dataset)))
                out.append(self._perm.pop())
            self._drawn += 1
            return self._drawn - 1, out

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return
            except queue.Full:
                pass

    def _worker(self):
        while not self._stop.is_set():
            seq, idxs = self._next_indices(self.batch_size)
            try:
                batch = collate([self.dataset[i] for i in idxs[self.rows]])
            except Exception as e:  # surface errors to the consumer
                self._put((seq, e))
                return
            self._put((seq, batch))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        while self._served not in self._ready:
            seq, item = self._queue.get()
            if isinstance(item, Exception):
                raise item
            self._ready[seq] = item
        item = self._ready.pop(self._served)
        self._served += 1
        return item

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join()
