"""The harness's core: cells, configurations, drivers and per-layer
metrics found by name; the measured window; spans; the result line.

A cell is `workloads/<name>.json` ({"config", "driver", "chips", "why",
"params", "limits"}); its configuration `configs/<config>.json`; its
driver `drivers/<driver>.py`, whose `run(ctx)` drives the program and
returns a `Result`; a per-layer metric `metrics/<metric>.py`, which
defines LAYER, UNIT, MOVES and `read(ctx, result)` (None where it finds
nothing to read). Which metrics a cell reports comes from BENCHMARK.json."""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
BANNED_MODULES = ("jax", "jaxlib", "flax", "spatialaudiogen_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def workload(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return load_json(bench_dir / "workloads" / f"{name}.json")


def config(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return load_json(bench_dir / "configs" / f"{name}.json")


def driver(name: str, bench_dir: Path = BENCH_DIR):
    return load_module(bench_dir / "drivers" / f"{name}.py", f"port_bench_driver_{name}")


def metric(name: str, bench_dir: Path = BENCH_DIR):
    return load_module(bench_dir / "metrics" / f"{name}.py",
                       "port_bench_metric_" + name.replace(".", "_"))


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """(end-to-end metric entries, per-layer metric entries) of `cell`: an
    end-to-end metric with no `workloads` key is every cell's; a per-layer
    metric is the cell's where it lists it, or, without the key, where the
    cell reports the metric it moves."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if cell in m.get("workloads", [cell] if m["moves"] in names else [])]
    return e2e, layer


def banned_imports() -> list:
    """Top-level names of loaded modules that the measured process may not
    hold (the JAX package's name is a prefix of the port's, so names are
    compared whole)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(BANNED_MODULES))


class Spans:
    """Host-clock spans by name, kept in memory; in a traced run each span
    is also a profiler range (`bench.<name>`), so idle gaps can be named by
    it."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.closed: dict = {}
        self.recording = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.traced:
            import torch

            rf = torch.profiler.record_function(f"bench.{name}")
        else:
            rf = contextlib.nullcontext()
        t0 = time.perf_counter()
        with rf:
            yield
        if self.recording:
            self.closed.setdefault(name, []).append(time.perf_counter() - t0)


@dataclasses.dataclass
class Result:
    metrics: dict                    # end-to-end name -> value
    attempted: int
    failed: int
    checks: list                     # [(name, value, limit)]
    info: dict = dataclasses.field(default_factory=dict)


class Context:
    """What a driver gets: the cell, its configuration, the run's seed,
    window length and trace switch, the device, spans, and the window."""

    def __init__(self, cell: str, wl: dict, cfg: dict, seed: int, seconds: float,
                 trace: bool, device: str, workdir: Path, t_start: float):
        self.cell, self.workload, self.config = cell, wl, cfg
        self.params = wl.get("params", {})
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.workdir, self.t_start = device, workdir, t_start
        self.spans = Spans(trace)
        self.window_s = None
        self.setup_s = None
        self.trace_summary = None
        self.result = None
        self._prof = None
        self._t0 = None

    def sync(self):
        if self.device.startswith("cuda"):
            import torch

            torch.cuda.synchronize()

    def open_window(self):
        """Set-up ends here: the device drained, then the clock (and, in a
        traced run, the profiler) started."""
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.startswith("cuda"):
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        self.sync()
        self._t0 = time.perf_counter()
        self.setup_s = self._t0 - self.t_start
        self.spans.recording = True

    def window_elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def close_window(self):
        """The device drained, the clock read; the profile reduced."""
        self.sync()
        self.window_s = time.perf_counter() - self._t0
        self.spans.recording = False
        if self._prof is not None:
            from port_bench.harness.trace import summarize

            self._prof.__exit__(None, None, None)
            self.trace_summary = summarize(self._prof, self.window_s)
            self._prof = None
