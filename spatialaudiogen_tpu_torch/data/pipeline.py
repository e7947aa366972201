"""Feeder: threaded multimodal chunk loading + batched device prefetch (the
port's copy of spatialaudiogen_tpu.data.pipeline, with `device_prefetch`
written for torch).

Replaces the reference's Python-thread + TF PaddingFIFOQueue feeder
(feeder.py:281-435) with a host-side worker pool feeding a bounded queue and
a prefetcher whose thread stages batches two ahead, through reused pinned
slots and a copy stream of its own, so decode and upload overlap device
compute. Mode semantics mirror the reference:

  train: every worker iterates a shuffled infinite epoch stream; each video
         visit samples 5 random chunks with random azimuth rotations
         (feeder.py:378-400); silence-gated by audio_pow.lst.
  eval:  one deterministic pass, skip_rate=10, chunk lists sharded across
         workers, no rotation/shuffle (feeder.py:379-381). Unlike the
         reference (which drops the ragged tail at dequeue_many), the final
         partial batch IS yielded.

Per-video channel masks come from meta/audio_layouts.txt (WXYZ -> all ones,
WXY -> Z masked; feeder.py:312-314).
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np

from spatialaudiogen_tpu_torch.data.generic import BackgroundGenerator
from spatialaudiogen_tpu_torch.data.providers import FilenameProvider
from spatialaudiogen_tpu_torch.data.readers import SampleReader, img_prep_default
from spatialaudiogen_tpu_torch.utils import profiling

_REPO_ROOT = os.path.realpath(os.path.join(os.path.dirname(__file__), "..", ".."))
DEFAULT_LAYOUTS = os.path.join(_REPO_ROOT, "meta", "audio_layouts.txt")

LAYOUT_MASKS = {"WXYZ": np.array([1.0, 1.0, 1.0, 1.0], np.float32),
                "WXY": np.array([1.0, 1.0, 0.0, 1.0], np.float32)}


def load_channel_masks(layouts_fn: str = DEFAULT_LAYOUTS) -> dict:
    masks = {}
    for line in open(layouts_fn).read().splitlines():
        parts = line.split()
        if len(parts) == 2 and parts[1] in LAYOUT_MASKS:
            masks[parts[0]] = LAYOUT_MASKS[parts[1]]
    return masks


class Feeder:
    NUM_SAMPLING_TRAIN = 5  # chunks per video visit in train mode
    EVAL_SKIP_RATE = 10

    def __init__(self, sample_dir: str,
                 subset_fn: str | None = None,
                 ambi_order: int = 1,
                 audio_rate: int = 48000,
                 video_rate: int = 10,
                 context: float = 1.0,
                 duration: float = 0.1,
                 return_video: bool = True,
                 img_prep=None,
                 return_flow: bool = False,
                 flow_prep=None,
                 batch_size: int = 32,
                 queue_size: int | None = None,
                 n_workers: int = 4,
                 for_eval: bool = False,
                 seed: int = 0,
                 layouts_fn: str = DEFAULT_LAYOUTS,
                 skip_silence_thr: float | None = "auto",
                 shard_id: int = 0,
                 num_shards: int = 1):
        self.sample_dir, self.subset_fn = sample_dir, subset_fn
        self.ambi_order = ambi_order
        self.audio_rate, self.video_rate = audio_rate, video_rate
        self.context, self.duration = context, duration
        self.return_video, self.return_flow = return_video, return_flow
        self.img_prep = img_prep if img_prep is not None else img_prep_default
        self.flow_prep = flow_prep
        self.batch_size = batch_size
        self.n_workers = n_workers
        self.for_eval = for_eval
        self.seed = seed
        # multi-host data sharding: each process feeds a disjoint video
        # subset (replaces the reference's thread_id split for hosts;
        # SURVEY 2.5).
        self.shard_id = shard_id
        self.num_shards = num_shards
        if skip_silence_thr == "auto":
            # reference default thresholds (feeder.py:310)
            skip_silence_thr = None if for_eval else (
                0.01 if (subset_fn and "REC-Street" in subset_fn) else 0.2)
        self.skip_silence_thr = skip_silence_thr

        if os.path.exists(layouts_fn):
            self.channel_mask = load_channel_masks(layouts_fn)
        else:
            self.channel_mask = {}
        self._default_mask = np.ones(((ambi_order + 1) ** 2,), np.float32)

        self._queue: queue.Queue = queue.Queue(
            maxsize=queue_size if queue_size is not None else 5 * batch_size)
        self._threads: list = []
        self._stop = threading.Event()
        self._starved = threading.Event()
        self._errors: list = []  # (worker_id, exception) from dead workers
        self._n_live = 0
        self._lock = threading.Lock()

    # --- introspection (parity with the feeder's startup report) ---
    def count_chunks(self) -> int:
        provider = FilenameProvider(self.sample_dir, self.subset_fn, num_epochs=1,
                                    shard=(self.shard_id, self.num_shards))
        total = 0
        for yid in provider.loop_samples():
            reader = SampleReader(os.path.join(self.sample_dir, yid),
                                  skip_silence_thr=self.skip_silence_thr,
                                  skip_rate=self.EVAL_SKIP_RATE if self.for_eval else None,
                                  return_video=False, shuffle=False,
                                  random_rotations=False,
                                  audio_rate=self.audio_rate,
                                  video_rate=self.video_rate)
            total += len(reader.chunks_t)
        return total

    # --- worker pool ---
    def start(self):
        assert not self._threads, "feeder already started"
        self._stop.clear()
        # A restarted feeder must not re-raise the previous pass's worker
        # errors / starvation on its first empty-queue poll.
        self._starved.clear()
        with self._lock:
            self._errors = []
        self._n_live = self.n_workers
        for i in range(self.n_workers):
            t = threading.Thread(target=self._worker_main, args=(i,), daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self):
        self._stop.set()
        for t in self._threads:
            while t.is_alive():
                try:  # drain so blocked put() calls can exit
                    self._queue.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.05)
        self._threads = []
        while True:  # chunks enqueued just before the last worker exited
            try:     # must not leak into a restarted feeder's batches
                self._queue.get_nowait()
            except queue.Empty:
                break

    def _worker_main(self, worker_id: int):
        try:
            rng = np.random.RandomState(self.seed * 1000 + worker_id)
            provider = FilenameProvider(
                self.sample_dir, self.subset_fn,
                num_epochs=1 if self.for_eval else np.inf,
                shuffle=not self.for_eval, seed=self.seed * 1000 + worker_id,
                shard=(self.shard_id, self.num_shards))
            n_sampling = np.inf if self.for_eval else self.NUM_SAMPLING_TRAIN
            consecutive_empty = 0
            sub_readers: dict = {}  # yid -> shared decode-cached sub-readers
            for yid in provider.loop_samples():
                if self._stop.is_set():
                    return
                if yid not in sub_readers:
                    if len(sub_readers) >= 4:
                        sub_readers.clear()
                    sub_readers[yid] = {}
                shared = sub_readers[yid]
                reader = SampleReader(
                    os.path.join(self.sample_dir, yid),
                    ambi_order=self.ambi_order,
                    audio_rate=self.audio_rate,
                    video_rate=self.video_rate,
                    context=self.context,
                    duration=self.duration,
                    return_video=self.return_video,
                    img_prep=self.img_prep,
                    return_flow=self.return_flow,
                    flow_prep=self.flow_prep,
                    skip_silence_thr=self.skip_silence_thr,
                    shuffle=not self.for_eval,
                    random_rotations=not self.for_eval,
                    skip_rate=self.EVAL_SKIP_RATE if self.for_eval else None,
                    worker_id=worker_id if self.for_eval else 0,
                    num_workers=self.n_workers if self.for_eval else 1,
                    rng=rng, **shared)
                shared["audio_reader"] = reader.audio_reader
                shared["video_reader"] = reader.video_reader
                shared["flow_reader"] = reader.flow_reader
                if not reader.chunks_t:
                    # every chunk of this video was filtered (e.g. all-silent
                    # under skip_silence_thr); in train mode a full dataset
                    # cycle of that would starve the queue forever — fail
                    # loudly. (Eval worker shards may be legitimately empty.)
                    consecutive_empty += 1
                    if not self.for_eval and consecutive_empty >= provider.num_samples:
                        self._starved.set()
                        return
                    continue
                consecutive_empty = 0
                for chunk in reader.loop_chunks(n_sampling):
                    chunk["audio_mask"] = self.channel_mask.get(yid, self._default_mask)
                    while not self._stop.is_set():
                        try:
                            self._queue.put(chunk, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
        except Exception as exc:  # noqa: BLE001 — surfaced in batches()
            # A dying worker must not be silent: eval would finish on
            # truncated data and train would spin on an empty queue forever.
            with self._lock:
                self._errors.append((worker_id, exc))
        finally:
            with self._lock:
                self._n_live -= 1

    def _exhausted(self) -> bool:
        with self._lock:
            return self._n_live <= 0

    def _raise_worker_errors(self):
        with self._lock:
            errors = list(self._errors)
        if errors:
            wid, exc = errors[0]
            raise RuntimeError(
                f"feeder worker {wid} died ({len(errors)} total): "
                f"{type(exc).__name__}: {exc}") from exc

    # --- batch iteration ---
    def batches(self):
        """Yields dict batches (numpy). Eval mode ends after one pass and
        includes the final partial batch; train mode is infinite."""
        items = []
        while True:
            try:
                with profiling.span("feeder.wait"):
                    items.append(self._queue.get(timeout=0.2))
            except queue.Empty:
                self._raise_worker_errors()
                if self._starved.is_set():
                    raise RuntimeError(
                        "Feeder starved: every candidate chunk was filtered "
                        "out (check skip_silence_thr vs the dataset's "
                        "audio_pow.lst levels).")
                if self.for_eval and self._exhausted():
                    # Drain chunks enqueued between our Empty and the last
                    # worker's exit (tail race) before finishing the pass.
                    while True:
                        try:
                            items.append(self._queue.get_nowait())
                        except queue.Empty:
                            break
                        if len(items) == self.batch_size:
                            yield self._collate(items)
                            items = []
                    if items:
                        yield self._collate(items)
                    return
                continue
            if len(items) == self.batch_size:
                yield self._collate(items)
                items = []

    @staticmethod
    def _collate(items: list) -> dict:
        batch = {"id": [c["id"] for c in items]}
        for key in items[0]:
            if key == "id":
                continue
            batch[key] = np.stack([c[key] for c in items], axis=0)
        return batch


class _PinnedRing:
    """The card's half of `device_prefetch`: pinned host slots for `size`
    batches in turn, one per array, allocated at the first batch and again
    only for an array whose shape or dtype changes; and the stream that
    copies them to the card, off the stream the step runs on."""

    def __init__(self, device, size: int):
        import torch

        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.slots = [{} for _ in range(size)]     # per entry: {key: pinned tensor}
        self.copied = [None] * size                # per entry: the event after its copies

    def upload(self, index: int, arrays: dict):
        """Copy `arrays` (host tensors) into the slots of batch `index`'s
        entry, once that entry's previous copies have ended, and queue their
        copies to the card -> (device tensors, the event after the copies)."""
        import torch

        entry = index % len(self.slots)
        if self.copied[entry] is not None:
            self.copied[entry].synchronize()
        slots = self.slots[entry]
        out = {}
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            for k, t in arrays.items():
                slot = slots.get(k)
                if slot is None or slot.shape != t.shape or slot.dtype != t.dtype:
                    slot = slots[k] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                with profiling.span("train.pin", index):
                    slot.copy_(t)
                with profiling.span("train.h2d", index):
                    out[k] = slot.to(self.device, non_blocking=True)
            copied = self.copied[entry] = torch.cuda.Event()
            copied.record(self.stream)
        return out, copied

    def release(self):
        """Wait for the copies in flight and let the slots go."""
        self.stream.synchronize()
        self.slots = [{} for _ in self.slots]
        self.copied = [None] * len(self.copied)


def device_prefetch(batch_iter, device, depth: int = 2, drop_keys=("id",)):
    """Stage batches for `device` `depth` batches ahead of the consumer
    (replaces the TF queue's CPU->GPU dequeue hop, feeder.py:369-370).

    A staging thread (a BackgroundGenerator) pulls the batches. On a CUDA
    device it copies each array into a pinned slot that it reuses `depth`
    + 1 batches later (span `train.pin`) and queues the copy to the card on
    a stream of its own (span `train.h2d`; both on the staging thread, with
    the batch's index as id), then records an event; the consumer's stream
    waits on that event and each device tensor is recorded on it, so the
    copies overlap the step and the host never waits for the card. On the
    CPU the arrays are wrapped without a copy. When the consumer takes a
    batch, the counter `train.h2d_bytes` adds the bytes of its arrays and
    `train.prefetch_ready` adds 1 if the batch was staged already (0 if the
    consumer had to wait). An error of the iterator or of a copy is raised
    at the consumer's next `next()`; closing the generator stops and joins
    the thread, also over an infinite iterator.
    Yields (device batch dict, host-only keys dict) in the iterator's order."""
    import torch

    device = torch.device(device)
    ring = None
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        ring = _PinnedRing(device, depth + 1)

    def staged():
        for index, batch in enumerate(batch_iter):
            host_keys = {k: batch[k] for k in drop_keys if k in batch}
            arrays = {k: torch.from_numpy(np.ascontiguousarray(v))
                      for k, v in batch.items() if k not in drop_keys}
            copied = None
            if ring is not None:
                arrays, copied = ring.upload(index, arrays)
            yield arrays, host_keys, copied

    stager = BackgroundGenerator(staged(), depth=depth)
    items = iter(stager)
    try:
        while True:
            ready = stager.ready()
            item = next(items, None)
            if item is None:
                return
            dev, host_keys, copied = item
            profiling.count("train.prefetch_ready", int(ready))
            if copied is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(copied)
                for t in dev.values():
                    t.record_stream(current)
            profiling.count("train.h2d_bytes", sum(t.nbytes for t in dev.values()))
            yield dev, host_keys
    finally:
        stager.close()
        if ring is not None:
            ring.release()
