#!/usr/bin/env python3
"""The serving cell's knee, found once (not run by the benchmark's runs).

    python3 port_bench/sweep_serve.py --workload audio_rgb.serve.open \
        --capacities 96,128,160,192 --seconds 20 --seed N

For each capacity, a batcher with that many sessions runs the cell's open
loop (drivers/serve.py) for `--seconds`, and one JSON line reports the
ticks' latency from their due times (p50, p95, max), the rounds, the
session-chunks due and emitted, how far the loop ran behind its schedule,
and the mean latency of the last quarter of the rounds against the first
(a backlog that grows shows as a rising latency)."""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR.parent))
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"      # as run.py runs the cells


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--capacities", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from port_bench.harness import core
    from port_bench.harness.weights import make_weights

    wl = core.workload(args.workload)
    cfg = core.config(wl["config"])
    drv = core.driver(wl["driver"])
    m = drv.model_shape(cfg)
    for cap in [int(c) for c in args.capacities.split(",")]:
        with tempfile.TemporaryDirectory(prefix="port_bench_sweep_") as work:
            ctx = core.Context(args.workload, wl, cfg, args.seed, args.seconds, False,
                               args.device, Path(work), time.perf_counter())
            weights = make_weights(m, args.seed, args.device)
            traffic = drv.Traffic(args.seed, m.geometry.snd_dur, m.frame_hw,
                                  wl["params"]["chunk_pool"], wl["params"]["frame_pool"])
            batcher = drv.build(ctx, m, weights, cap)
            sids = [batcher.add_session() for _ in range(cap)]
            first = drv.warm(batcher, sids, traffic, wl["params"]["warm_steps"])
            run = drv.open_loop(batcher, sids, traffic, first, args.seconds)
            lat = np.asarray(run["latency"]) * 1e3
            q = max(1, len(lat) // 4)
            print(json.dumps({"capacity": cap, "rounds": len(lat),
                              "p50_ms": float(np.percentile(lat, 50)),
                              "p95_ms": float(np.percentile(lat, 95)),
                              "max_ms": float(lat.max()),
                              "first_quarter_ms": float(lat[:q].mean()),
                              "last_quarter_ms": float(lat[-q:].mean()),
                              "due": run["due"], "emitted": run["emitted"],
                              "late_s": run["late_s"],
                              "device": torch.cuda.get_device_name(0)
                              if args.device.startswith("cuda") else "cpu"}), flush=True)
            del batcher, weights
            gc.collect()
            if args.device.startswith("cuda"):
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
