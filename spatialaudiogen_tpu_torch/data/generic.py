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
    """Runs an iterator in a daemon thread, buffering up to `depth` items.

    An error the iterator raises is raised at the consumer's next `next()`.
    `close()`, which the consumer's iteration also runs when it ends or is
    closed, stops the thread at its next hand-over (an infinite iterator
    too, once its current item is made), joins it and drops what the queue
    holds."""

    _DONE = object()
    _POLL_S = 0.05      # how often a hand-over blocked on a full queue looks for close()

    def __init__(self, iterable, depth: int = 4):
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(iterable,), daemon=True)
        self._err = None
        self._thread.start()

    def _run(self, iterable):
        try:
            for item in iterable:
                if not self._put(item):
                    return
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            self._put(self._DONE)

    def _put(self, item) -> bool:
        """Queue `item`; False, with nothing queued, once close() was called."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=self._POLL_S)
                return True
            except queue.Full:
                pass
        return False

    def ready(self) -> bool:
        """Whether the next item is queued already, so taking it will not wait."""
        return not self._queue.empty()

    def __iter__(self):
        try:
            while True:
                item = self._queue.get()
                if item is self._DONE:
                    if self._err is not None:
                        raise self._err
                    return
                yield item
        finally:
            self.close()

    def close(self):
        """Stop the thread, join it and drop the items it queued."""
        self._stop.set()
        if self._thread is not threading.current_thread():    # a collector may run it there
            self._thread.join()
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                return


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
