"""Batches of a map-style dataset, assembled on a background thread.

The JAX package's ``data/loader.py:PrefetchLoader`` without its device
transfer (the trainer moves each batch to its device): the same seeded
order (``seed * 7919 + epoch``), ``drop_last``, and ``prefetch`` batches
assembled ahead of the consumer, so host clip sampling overlaps the
device's work on the step before.
"""

import queue
import threading
from typing import Iterator, Sequence

import numpy as np


class PrefetchLoader:
    """Iterate fixed-shape numpy batches (tuples of stacked item fields)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n)
        return np.random.default_rng(self.seed * 7919 + self.epoch).permutation(n)

    def _assemble(self, indices: Sequence[int]):
        items = [self.dataset[int(i)] for i in indices]
        return tuple(np.stack(p) for p in zip(*items))

    def __iter__(self) -> Iterator:
        order = self._order()
        n_batches = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                for b in range(n_batches):
                    if stop.is_set():
                        return
                    q.put(self._assemble(order[b * self.batch_size : (b + 1) * self.batch_size]))
                q.put(None)
            except BaseException as e:  # surface worker errors to the consumer
                q.put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # Drain so the producer can exit if blocked on put().
            while thread.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=1.0)
