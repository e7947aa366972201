"""Render spherical power maps of an ambisonics wav as a video (the port's
copy of spatialaudiogen_tpu.cli.power_map).

Parity with reference scripts/gen_sph_power_map.py: windowed RMS maps over
an angular grid, inferno colormap, optional ground-truth source overlay.

    python -m spatialaudiogen_tpu_torch.cli.power_map INPUT_WAV OUTPUT_MP4 \
        [--position_fn P] [--angular_res 5]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("input_fn")
    parser.add_argument("output_fn")
    parser.add_argument("--position_fn", default="")
    parser.add_argument("--angular_res", type=float, default=5.0)
    parser.add_argument("--scale", type=int, default=4,
                        help="integer upscale of the map frames")
    args = parser.parse_args(argv)

    from matplotlib import pyplot as plt

    from spatialaudiogen_tpu_torch.ambisonics.maps import (
        SphericalAmbisonicsVisualizer,
        SphericalSourceVisualizer,
    )
    from spatialaudiogen_tpu_torch.utils.io_audio import load_wav
    from spatialaudiogen_tpu_torch.utils.io_video import VideoWriter

    data, rate = load_wav(args.input_fn)
    duration = data.shape[0] / float(rate)
    vis = SphericalAmbisonicsVisualizer(data, rate, angular_res=args.angular_res)
    src_vis = None
    if args.position_fn:
        src_vis = SphericalSourceVisualizer(args.position_fn, duration,
                                            vis.visualization_rate(),
                                            angular_res=args.angular_res)
    writer = VideoWriter(args.output_fn, fps=vis.visualization_rate())
    cmap = np.stack(plt.get_cmap("inferno").colors)
    n = 0
    for frame in vis.loop_frames():
        frame = frame / (frame.max() + 1e-12)
        if src_vis is not None:
            gt = src_vis.get_next_frame()
            if gt is not None:
                frame = frame + gt
        frame = np.clip(frame / (frame.max() + 1e-12) * 255, 0, 255).astype(np.uint8)
        rgb = (cmap[frame] * 255).astype(np.uint8)
        rgb = np.kron(rgb, np.ones((args.scale, args.scale, 1), np.uint8))
        writer.write_frame(rgb)
        n += 1
    writer.close()
    print(f"Wrote {n} map frames to {args.output_fn}")


if __name__ == "__main__":
    main()
