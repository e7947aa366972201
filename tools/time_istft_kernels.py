#!/usr/bin/env python3
"""Times the port's masked comb-ISTFT kernels (K1, K2, K3) on one CUDA card
at the flagship's shapes (32 tracks, 28 mask frames, F = 1024, f32 mask),
batch 16 and 128, on the model's default route (pallas_precision
"default", bf16 wgmma). Prints one line per (kernel, batch) with the
median of `--iters` CUDA-event timings, and the card's name and power
limit.

    python tools/time_istft_kernels.py [--iters 50] [--repeats 3]

Run it from the root of a checkout: the kernels are built from that
checkout's sources. To compare two checkouts, run both in one call on
one card, in turns (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

from spatialaudiogen_tpu_torch.ops import masked_istft as k  # noqa: E402


def median_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_istft_kernels: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    k.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    tracks, t, f = 32, 28, 1024
    for batch in (16, 128):
        re = torch.randn((batch, 1, t, f), generator=gen, device="cuda")
        im = torch.randn((batch, 1, t, f), generator=gen, device="cuda")
        mask = torch.rand((batch, 1, tracks, t, f), generator=gen, device="cuda")
        g = torch.randn((batch, 1, tracks, (t // 4) * f - 3 * f // 4), generator=gen,
                        device="cuda")
        nhwc = mask[:, 0].permute(0, 2, 3, 1).contiguous()   # (B, T, F, TR)
        calls = {
            "K1": lambda: k.masked_istft(re, im, mask, 4, "default"),
            "K2": lambda: k.masked_istft_bwd(re, im, mask, g, 4, "default"),
            "K3": lambda: k.masked_istft_nhwc(re[:, 0], im[:, 0], nhwc, 4, "default"),
        }
        with torch.no_grad():
            for name, fn in calls.items():
                ms = [median_ms(fn, args.iters) for _ in range(args.repeats)]
                print(f"{name} batch {batch}: " + " ".join(f"{x:.4f}" for x in ms)
                      + f" ms (medians of {args.iters}) [{card}]", flush=True)
        del re, im, mask, g, nhwc
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
