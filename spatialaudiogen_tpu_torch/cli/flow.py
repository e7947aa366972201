"""Compute optical flow for preprocessed videos (the flow modality); the
port's counterpart of spatialaudiogen_tpu.cli.flow, plus --device.

Capability parity with the reference's `compute_flow` preprocessing stage
(scraping/preprocess.py:156-204 + scraping/flow.py), which ran FlowNet2
through an external Caffe checkout. Flow stays pluggable here:

  * By DEFAULT this uses OpenCV Farneback dense flow — dependency-free, but
    NOT the FlowNet2 flow the paper's flow encoder was trained on. Models
    trained on Farneback flow are not weight-compatible with the released
    flow-encoder checkpoints.
  * --method tpu runs the framework's own pyramidal Horn-Schunck solver on
    the torch --device (ops/flow.py; the card by default) — no OpenCV, no
    external binary; the same FlowNet2-parity caveat applies. The method
    keeps the JAX package's name, so its invocations run unchanged.
  * Pass --command to run any external flow model (FlowNet2, RAFT, ...);
    the template gets {frames_dir} and {output_fn} substituted and must
    write a (T, H, W, 2) float .npy to {output_fn}. NaN outputs retry up to
    5 times (reference scraping/flow.py:44-56 policy).

Output is the feeder's compressed angle/magnitude jpg layout +
flow_limits.npy under  FRAMES_DIR/<yid>/flow/ .

    sag-torch-flow db.lst --frames_dir data/frames [--method tpu] [--device cuda] \
        [--command 'run_raft.sh ...']
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("db_list", help="File with one youtube id per line.")
    parser.add_argument("--frames_dir", default="data/frames",
                        help="Root of the preprocessed frames layout.")
    parser.add_argument(
        "--command", default=None,
        help="External flow command template with {frames_dir} {output_fn} "
             "placeholders (e.g. FlowNet2/RAFT). Default: OpenCV Farneback — "
             "NOT FlowNet2; see --help header for the parity caveat.")
    parser.add_argument("--method", default="farneback",
                        choices=["farneback", "tpu"],
                        help="Built-in flow solver when no --command is "
                             "given: OpenCV Farneback on the host, or the "
                             "pyramidal Horn-Schunck solver on --device "
                             "(ops/flow.py).")
    parser.add_argument("--fb_occlusion", action="store_true",
                        help="--method tpu only: solve backward flow too "
                             "and gate occluded pixels' data term off via "
                             "forward-backward consistency (~2x device "
                             "work; better local motion under occlusion — "
                             "measured trade in tests/test_flow_quality.py).")
    parser.add_argument("--device", default="cuda",
                        help="torch device of --method tpu (default cuda).")
    parser.add_argument("--overwrite", action="store_true",
                        help="Recompute even if <yid>/flow/ already exists.")
    args = parser.parse_args(argv)

    from spatialaudiogen_tpu_torch.etl.flow import ExternalFlowModel, flow_for_frames

    model = ExternalFlowModel(args.command) if args.command else None
    with open(args.db_list) as f:
        yids = [ln.strip().split()[0] for ln in f if ln.strip()]

    n_done = n_skipped = 0
    for yid in yids:
        video_dir = os.path.join(args.frames_dir, yid, "video")
        flow_dir = os.path.join(args.frames_dir, yid, "flow")
        if not os.path.isdir(video_dir):
            print(f"{yid}: no video frames, skipping")
            n_skipped += 1
            continue
        if os.path.exists(os.path.join(flow_dir, "flow_limits.npy")) \
                and not args.overwrite:
            n_skipped += 1
            continue
        flow_for_frames(video_dir, flow_dir, model=model, method=args.method,
                        fb_occlusion=args.fb_occlusion, device=args.device)
        n_done += 1
        print(f"{yid}: flow done")
    print(f"flow: {n_done} computed, {n_skipped} skipped")


if __name__ == "__main__":
    main()
