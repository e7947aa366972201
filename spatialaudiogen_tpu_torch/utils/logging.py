"""Metric logging: stdout stat lines + JSONL metric stream (the port's copy of
spatialaudiogen_tpu.utils.logging.MetricLogger, without TensorBoard).

Writes model_dir/metrics.jsonl, one record per logged step, and prints the
reference's style of throughput line (train.py:157-163, myutils.py:8-26).
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import deque
from datetime import datetime


class MetricLogger:
    def __init__(self, model_dir: str, fname: str = "metrics.jsonl", window: int = 20):
        os.makedirs(model_dir, exist_ok=True)
        self.path = os.path.join(model_dir, fname)
        self._f = open(self.path, "a")
        self.durations: deque = deque(maxlen=window)

    def tick(self, duration: float):
        self.durations.append(duration)

    def samples_per_sec(self, batch_size: int) -> float:
        if not self.durations:
            return 0.0
        return len(self.durations) * batch_size / sum(self.durations)

    def log(self, step: int, metrics: dict, batch_size: int, tag: str = "TRAIN"):
        values = {k: float(v) for k, v in metrics.items()}
        rec = {"step": step, "time": time.time(), "tag": tag, **values}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        sps = self.samples_per_sec(batch_size)
        ts = datetime.now()
        header = f"{ts}: {tag} | step {step}"
        if sps > 0:
            header += f" ({sps:.3f} samples/sec | {1.0 / sps:.3f} secs/sample)"
        print(header)
        for name, val in values.items():
            print(f"{ts}: {tag} | \t {name} {val:f}")
        sys.stdout.flush()

    def close(self):
        self._f.close()
