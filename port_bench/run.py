#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell's file (workloads/<cell>.json)
names its configuration and driver; the driver builds the program's inputs
and weights from the seed, warms up, measures for `--seconds`, and checks
the program's output against the plain reference (reference/). The last
line of standard output is one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics, or with --trace 1 its per-layer
metrics), device, with --trace 1 breakdown, and last the numbers that were
compared with their limits, which also end standard error. Exits non-zero
with no result when the card or the program is missing, or when JAX or
the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# one thread per BLAS and OpenMP call: the feeder's eight threads each
# rotate windows with numpy, whose BLAS would otherwise start a team of
# threads per call on the same eight cores (set before numpy loads)
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"
# build and kernel caches at fixed paths inside the checkout; a library the
# program uses must not load JAX on its own
os.environ["TRITON_CACHE_DIR"] = str(BENCH_DIR / ".cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BENCH_DIR / ".cache" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(ROOT))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str,
             bench_dir: Path = BENCH_DIR, overrides: dict | None = None,
             t_start: float | None = None):
    """-> (result line dict, [(name, value, limit)], [(kernel, device
    seconds)] of the 25 longest in a traced run). `overrides` replaces
    entries of the cell's params and configuration (the CPU tests' small
    shapes)."""
    from port_bench.harness import core

    bench = core.load_json(bench_dir.parent / "BENCHMARK.json") if (
        bench_dir.parent / "BENCHMARK.json").exists() else None
    wl = core.workload(cell, bench_dir)
    cfg = core.config(wl["config"], bench_dir)
    overrides = overrides or {}
    wl = {**wl, "params": {**wl.get("params", {}), **overrides.get("params", {})},
          "limits": {**wl.get("limits", {}), **overrides.get("limits", {})}}
    cfg = {**cfg, **overrides.get("config", {})}
    drv = core.driver(wl["driver"], bench_dir)
    with tempfile.TemporaryDirectory(prefix="port_bench_") as work:
        ctx = core.Context(cell, wl, cfg, seed, seconds, trace, device, Path(work),
                           T_START if t_start is None else t_start)
        result = drv.run(ctx)
        ctx.result = result
    e2e, layer = core.cell_metrics(bench, cell) if bench else ([], [])
    metrics = {}
    if trace:
        for entry in layer:
            value = core.metric(entry["name"], bench_dir).read(ctx, result)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    else:
        values = {**result.metrics, "setup_s": ctx.setup_s}
        for entry in e2e:
            if entry["name"] in values:
                metrics[entry["name"]] = {"value": values[entry["name"]], "unit": entry["unit"]}
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu", "kind": None,
           "count": wl.get("chips", 1),
           "memory_peak_bytes": result.info.get("memory_peak_bytes"), "power_limit_w": None}
    line = {"correct": all(v <= lim for _, v, lim in result.checks) and bool(result.checks),
            "attempted": result.attempted, "failed": result.failed,
            "metrics": metrics, "device": dev}
    if trace and ctx.trace_summary is not None:
        dev["busy_s"] = ctx.trace_summary.busy_s
        dev["window_s"] = ctx.trace_summary.window_s
        line["breakdown"] = ctx.trace_summary.breakdown
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in result.checks}
    kernels = (sorted(ctx.trace_summary.kernel_s.items(), key=lambda kv: -kv[1])[:25]
               if ctx.trace_summary is not None else [])
    return line, result.checks, kernels


def main(argv=None) -> int:
    args = parse(argv)
    from port_bench.harness import core

    wl = core.workload(args.workload)
    import torch

    chips = wl.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line, checks, kernels = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    line["device"]["kind"] = torch.cuda.get_device_name(0)
    line["device"]["power_limit_w"] = power_limit_w()
    banned = core.banned_imports()
    if banned:
        print(f"port_bench: the measured process loaded {banned}", file=sys.stderr)
        return 3
    for name, seconds in kernels:
        print(f"kernel {seconds:.6f} s  {name[:160]}", file=sys.stderr)
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
