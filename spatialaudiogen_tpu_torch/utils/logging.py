"""Metric logging: stdout stat lines, a JSONL metric stream and TensorBoard
events (the port's copy of spatialaudiogen_tpu.utils.logging.MetricLogger).

Writes model_dir/metrics.jsonl, one record per logged step, the same
scalars as TensorBoard events (utils.tensorboard, on by default as in the
JAX package), and prints the reference's style of throughput line
(train.py:157-163, myutils.py:8-26).
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import deque
from datetime import datetime

import numpy as np


class MetricLogger:
    def __init__(self, model_dir: str, fname: str = "metrics.jsonl",
                 window: int = 20, tensorboard: bool = True):
        os.makedirs(model_dir, exist_ok=True)
        self.path = os.path.join(model_dir, fname)
        self._f = open(self.path, "a")
        self.durations: deque = deque(maxlen=window)
        self._tb = None
        if tensorboard:
            from spatialaudiogen_tpu_torch.utils.tensorboard import TBEventWriter

            self._tb = TBEventWriter(model_dir)

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
        if self._tb is not None:
            for name, val in values.items():
                self._tb.add_scalar(name, val, step)
            self._tb.flush()
        sps = self.samples_per_sec(batch_size)
        ts = datetime.now()
        header = f"{ts}: {tag} | step {step}"
        if sps > 0:
            header += f" ({sps:.3f} samples/sec | {1.0 / sps:.3f} secs/sample)"
        print(header)
        for name, val in values.items():
            print(f"{ts}: {tag} | \t {name} {val:f}")
        sys.stdout.flush()

    def log_histograms(self, step: int, tensors: dict, prefix: str = "params"):
        """One TensorBoard histogram per entry of `tensors` ({name: tensor or
        array}), tagged f"{prefix}/{name}": the reference's verbosity-gated
        variable histograms (dnn.py:692-709). The trainer passes the JAX
        package's '/'-joined paths as names (models.convert.to_flax), so the
        tags are the ones a JAX run writes. No-op without a TB writer."""
        if self._tb is None:
            return
        for name, value in tensors.items():
            if hasattr(value, "detach"):
                value = value.detach().float().cpu().numpy()
            self._tb.add_histogram(f"{prefix}/{name}", np.asarray(value), step)
        self._tb.flush()

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
