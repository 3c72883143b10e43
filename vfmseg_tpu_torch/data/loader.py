"""Prefetching data loader.

Port of vfmseg_tpu/data/loader.py: worker threads build shuffled batches
ahead of the training loop and collate them into numpy arrays; the train
step moves them to the device. With one worker the batch order depends only
on the seed. :meth:`InfiniteLoader.close` stops and joins the workers.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


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
                 seed: int = 0, prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(num_workers, 1)
        self.rng = np.random.default_rng(seed)
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._index_lock = threading.Lock()
        self._perm: list = []
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(self.num_workers)
        ]
        for t in self._threads:
            t.start()

    def _next_indices(self, n: int):
        with self._index_lock:
            out = []
            for _ in range(n):
                if not self._perm:
                    self._perm = list(self.rng.permutation(len(self.dataset)))
                out.append(self._perm.pop())
            return out

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return
            except queue.Full:
                pass

    def _worker(self):
        while not self._stop.is_set():
            idxs = self._next_indices(self.batch_size)
            try:
                batch = collate([self.dataset[i] for i in idxs])
            except Exception as e:  # surface errors to the consumer
                self._put(e)
                return
            self._put(batch)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        item = self._queue.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join()
