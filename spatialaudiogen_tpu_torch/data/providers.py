"""Dataset sample-id iteration (parity with reference feeder.py:12-47; the
port's copy of spatialaudiogen_tpu.data.providers)."""

from __future__ import annotations

import math
import os
import random


class FilenameProvider:
    """Iterates video ids in a dataset directory, optionally filtered by a
    subset list file, for a number of epochs, with reshuffling per epoch."""

    def __init__(self, directory: str, subset_fn: str | None = None,
                 num_epochs: float = 1, shuffle: bool = False, seed: int | None = None,
                 shard: tuple | None = None):
        self.directory = directory
        self.sample_ids = sorted(os.listdir(directory))
        assert len(self.sample_ids) > 0, "Dataset directory is empty."
        if subset_fn is not None:
            assert os.path.exists(subset_fn), subset_fn
            subset = set(open(subset_fn).read().splitlines())
            self.sample_ids = [y for y in self.sample_ids if y in subset]
            assert self.sample_ids, f"No dataset samples match subset {subset_fn}"
        if shard is not None:
            shard_id, num_shards = shard
            if num_shards > 1:
                self.sample_ids = self.sample_ids[shard_id::num_shards]
                assert self.sample_ids, \
                    f"shard {shard_id}/{num_shards} has no videos"
        self.num_epochs, self.epoch = num_epochs, 0
        self.num_samples = len(self.sample_ids)
        self.shuffle = shuffle
        self.rng = random.Random(seed)
        self.head = -1

    def get_next_sample(self):
        self.head = (self.head + 1) % self.num_samples
        if self.head == 0:
            self.epoch += 1
            if self.epoch > self.num_epochs:
                return None
            if self.shuffle:
                self.rng.shuffle(self.sample_ids)
        return self.sample_ids[self.head]

    def loop_samples(self):
        while True:
            yid = self.get_next_sample()
            if yid is None:
                break
            yield yid

    def __len__(self):
        if math.isinf(self.num_epochs):
            raise ValueError("infinite provider")
        return int(self.num_epochs) * self.num_samples
