"""Optical-flow ingestion for the flow encoder (the port's copy of
spatialaudiogen_tpu.etl.flow; method "tpu" solves on a torch device).

The reference wraps an external FlowNet2/Caffe checkout (scraping/flow.py)
and retries GPU inference up to 5 times on NaNs. Here flow stays pluggable:

  * `ExternalFlowModel` shells out to any command that maps a frames
    directory to .npy/.flo flow fields (a modern RAFT checkpoint, FlowNet2,
    or anything else), with the same NaN-retry policy;
  * `farneback_flow` computes classical dense flow with OpenCV — a
    dependency-free default so the flow modality works out of the box;
  * `ops.flow.horn_schunck_flow` (method "tpu", the name the JAX package's
    flag gave it) solves pyramidal Horn-Schunck on a torch device;
  * `flow_for_frames` runs one and compresses the result to the feeder's
    angle/magnitude jpg format (etl.preprocess.compress_flow).
"""

from __future__ import annotations

import os
import subprocess

import numpy as np

MAX_NAN_RETRIES = 5  # reference scraping/flow.py:44-56 policy


def farneback_flow(frames: np.ndarray) -> np.ndarray:
    """(T, H, W, 3) uint8/float frames -> (T, H, W, 2) flow (last repeats).

    Flow[t] estimates motion frame t -> t+1 (Farneback dense flow).
    """
    import cv2

    t = frames.shape[0]
    grays = [cv2.cvtColor(frames[i].astype(np.uint8), cv2.COLOR_RGB2GRAY)
             for i in range(t)]
    out = np.zeros(frames.shape[:3] + (2,), np.float32)
    for i in range(t - 1):
        out[i] = cv2.calcOpticalFlowFarneback(
            grays[i], grays[i + 1], None, pyr_scale=0.5, levels=3, winsize=15,
            iterations=3, poly_n=5, poly_sigma=1.2, flags=0)
    if t > 1:
        out[-1] = out[-2]
    return out


class ExternalFlowModel:
    """Run an external flow command with NaN-retry.

    command template placeholders: {frames_dir} {output_fn}; the command must
    write an (T, H, W, 2) float .npy to {output_fn}.
    """

    def __init__(self, command_template: str, max_retries: int = MAX_NAN_RETRIES):
        self.command_template = command_template
        self.max_retries = max_retries

    def compute(self, frames_dir: str, output_fn: str) -> np.ndarray:
        for attempt in range(self.max_retries):
            cmd = self.command_template.format(frames_dir=frames_dir,
                                               output_fn=output_fn)
            subprocess.run(cmd, shell=True, check=True)
            flow = np.load(output_fn)
            if not np.isnan(flow).any():
                return flow
        raise RuntimeError(
            f"flow model produced NaNs {self.max_retries} times for {frames_dir}")


def flow_for_frames(frames_dir: str, flow_dir: str,
                    model: ExternalFlowModel | None = None,
                    method: str = "farneback",
                    fb_occlusion: bool = False, device: str = "cuda") -> np.ndarray:
    """Compute flow for a video's jpg frames dir and write the compressed
    angle/magnitude jpg + flow_limits.npy layout the feeder reads.

    method: "farneback" (OpenCV, host CPU) or "tpu" (pyramidal
    Horn-Schunck on the torch `device`, ops/flow.py; the card unless the
    caller passes "cpu"). Ignored when `model` (an external command) is
    given.

    fb_occlusion (tpu method only): forward-backward consistency masking
    of occluded pixels' data term (ops/flow.py _occlusion_weight) — ~2x
    device work; helps content with strong foreground/background parallax,
    measured trade in tests/test_flow_quality.py.
    """
    from PIL import Image

    from spatialaudiogen_tpu_torch.etl.preprocess import compress_flow

    fns = sorted(fn for fn in os.listdir(frames_dir) if fn.endswith(".jpg"))
    frames = np.stack([np.asarray(Image.open(os.path.join(frames_dir, fn)))
                       for fn in fns])
    if model is None:
        if method == "tpu":
            from spatialaudiogen_tpu_torch.ops.flow import horn_schunck_flow

            flow = horn_schunck_flow(frames, fb_occlusion=fb_occlusion, device=device)
        else:
            assert method == "farneback", method
            flow = farneback_flow(frames)
    else:
        tmp_fn = os.path.join(flow_dir, "_raw_flow.npy")
        os.makedirs(flow_dir, exist_ok=True)
        flow = model.compute(frames_dir, tmp_fn)
        os.remove(tmp_fn)
    compress_flow(flow, flow_dir)
    return flow
