"""The port's Horn-Schunck solver on the CPU over chip_smoke.py phase 17's
frames: the float32 solve's quality (zoom + pan EPE, the blob's and the
background's mean x-flow) and its largest distance from a float64 run of
the same solve, with fb_occlusion off and on. What phase 17 holds the card
to rests on these numbers.

    python tools/flow_cpu_reference.py [--threads 4]   # from the repo root
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke  # noqa: E402
from spatialaudiogen_tpu_torch.ops.flow import flow_pairs  # noqa: E402


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--threads", type=int, default=4)
    args = parser.parse_args(argv)
    torch.set_num_threads(args.threads)
    frames, gt, masks = chip_smoke.flow_frames()
    gray = (frames.astype(np.float32) @ np.array([0.299, 0.587, 0.114], np.float32)) / 255.0
    i1, i2 = torch.from_numpy(gray[:-1]), torch.from_numpy(gray[1:])
    with torch.inference_mode():
        for fb in (False, True):
            f32 = flow_pairs(i1, i2, fb_occlusion=fb).numpy()
            f64 = flow_pairs(i1.double(), i2.double(), fb_occlusion=fb).numpy()
            flow = np.concatenate([f32, f32[-1:]])
            q = chip_smoke.flow_quality(flow, gt, masks)
            print(f"fb_occlusion={'on' if fb else 'off'}: float32 vs float64 max |diff| "
                  f"{np.abs(f32 - f64).max():.3e} px; zoom + pan EPE {q['epe']:.4f} px; "
                  f"blob u {q['blob_u']:.3f} (true {chip_smoke.FLOW_BLOB_STEP}); background u "
                  f"{q['background_u']:.3f} (true {q['background_true_u']:.3f})")


if __name__ == "__main__":
    main()
