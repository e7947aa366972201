#!/usr/bin/env python3
"""Readings that a cell's limits are set from (not run by the benchmark's
own runs).

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--out FILE]

For each seed the cell's driver runs the program at the cell's own size,
without a measured window (`readings(ctx, faults)` of drivers/<driver>.py),
and reports the numbers the check compares for that sound run; for each
control seed also, on the same inputs, those of the control (the
reference one precision step below the configuration's, in the program's
place) and of the driver's faults. One JSON line per seed; with --out, all
of them in a file.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR.parent))

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    from port_bench.harness import core

    wl = core.workload(args.workload)
    cfg = core.config(wl["config"])
    drv = core.driver(wl["driver"])
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="port_bench_cal_") as work:
            ctx = core.Context(args.workload, wl, cfg, seed, 0.0, False, args.device,
                               Path(work), t0)
            row = {"workload": args.workload, "seed": seed,
                   **drv.readings(ctx, seed in controls)}
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
