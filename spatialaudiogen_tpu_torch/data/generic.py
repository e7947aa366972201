"""Generic in-memory datasets and background batch generation (the port's
copy of spatialaudiogen_tpu.data.generic; reference pyutils/tflib/inputs.py:
Dataset / DataGenerator / PythonFeeder / Donkey pool): array-backed batch
iteration with shuffling, a background thread that keeps a bounded queue
of prepared batches, and a process pool for CPU-heavy per-item map
functions."""

from __future__ import annotations

import multiprocessing
import queue
import threading
from concurrent.futures import ProcessPoolExecutor

import numpy as np


class ArrayDataset:
    """Shuffled minibatch iterator over parallel arrays (one permutation of
    RandomState(seed) per pass, as the JAX class draws it)."""

    def __init__(self, *arrays, batch_size: int = 32, shuffle: bool = True,
                 seed: int = 0, drop_remainder: bool = False):
        assert arrays and all(a.shape[0] == arrays[0].shape[0] for a in arrays)
        self.arrays = arrays
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        n = self.arrays[0].shape[0]
        return n // self.batch_size if self.drop_remainder else -(-n // self.batch_size)

    def __iter__(self):
        n = self.arrays[0].shape[0]
        order = self.rng.permutation(n) if self.shuffle else np.arange(n)
        for i in range(0, n, self.batch_size):
            idx = order[i: i + self.batch_size]
            if self.drop_remainder and idx.size < self.batch_size:
                return
            yield tuple(a[idx] for a in self.arrays)


class BackgroundGenerator:
    """Runs an iterator in a daemon thread, buffering up to `depth` items."""

    _DONE = object()

    def __init__(self, iterable, depth: int = 4):
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._run, args=(iterable,), daemon=True)
        self._err = None
        self._thread.start()

    def _run(self, iterable):
        try:
            for item in iterable:
                self._queue.put(item)
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            self._queue.put(self._DONE)

    def __iter__(self):
        while True:
            item = self._queue.get()
            if item is self._DONE:
                if self._err is not None:
                    raise self._err
                return
            yield item


def parallel_map(fn, items, n_workers: int = 4, chunksize: int = 1):
    """Process-pool map for CPU-heavy per-item work (Donkey pool equivalent,
    inputs.py:324-438). The workers are spawned, never forked (the caller
    may hold threads and a CUDA context), so `fn` must be importable by
    name and the items picklable."""
    if n_workers <= 1:
        return [fn(x) for x in items]
    with ProcessPoolExecutor(max_workers=n_workers,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        return list(pool.map(fn, items, chunksize=chunksize))
