"""Background batch generation (the port's copy of
spatialaudiogen_tpu.data.generic.BackgroundGenerator, the reference's
PythonFeeder equivalent, pyutils/tflib/inputs.py:16-150)."""

from __future__ import annotations

import queue
import threading


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
