"""Binauralize an ambisonics wav to stereo (sag-torch-binauralize; the port's
counterpart of spatialaudiogen_tpu.cli.binauralize, numpy and scipy).

Parity with reference scripts/binauralize_ambisonics.py (+ the source-based
variants via --position_fn, cf. binauralize_sources.py).

    python -m spatialaudiogen_tpu_torch.cli.binauralize INPUT_WAV OUTPUT_WAV \
        [--method projection|pseudoinv|direct] [--use_hrtfs --cipic_dir D] \
        [--position_fn P --base_dir D]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("input_fn", help="Ambisonics wav (or mono wav with --position_fn).")
    parser.add_argument("output_fn")
    parser.add_argument("--method", default="projection",
                        choices=["projection", "pseudoinv", "direct"])
    parser.add_argument("--use_hrtfs", action="store_true")
    parser.add_argument("--cipic_dir", default=None)
    parser.add_argument("--position_fn", default=None,
                        help="Binauralize point sources from a position file instead.")
    parser.add_argument("--base_dir", default=None)
    parser.add_argument("--rate", type=int, default=None)
    parser.add_argument("--xyz", nargs=3, type=float, default=None,
                        metavar=("X", "Y", "Z"),
                        help="binauralize INPUT_WAV (mono) as a point source "
                             "at this fixed cartesian position (reference "
                             "binauralize_sources_xyz.py:9-19)")
    args = parser.parse_args(argv)

    from spatialaudiogen_tpu_torch.ambisonics.binauralizer import (
        AmbisonicBinauralizer,
        DirectAmbisonicBinauralizer,
        SourceBinauralizer,
    )
    from spatialaudiogen_tpu_torch.ambisonics.format import AmbiFormat
    from spatialaudiogen_tpu_torch.ambisonics.position import MovingSource, PositionalSource
    from spatialaudiogen_tpu_torch.utils.io_audio import load_wav, save_wav

    if args.xyz is not None:
        from spatialaudiogen_tpu_torch.ambisonics.position import Position

        mono, rate = load_wav(args.input_fn, args.rate)
        if mono.ndim == 2:
            mono = mono[:, 0]
        binauralizer = SourceBinauralizer(use_hrtfs=args.use_hrtfs,
                                          cipic_dir=args.cipic_dir)
        stereo = binauralizer.binauralize(
            [PositionalSource(mono, Position(*args.xyz, "cartesian"),
                              int(rate))])
    elif args.position_fn:
        from spatialaudiogen_tpu_torch.utils.io_position import read_position_file

        mono, rate = load_wav(args.input_fn, args.rate)
        mono = mono[:, 0]
        positions, _, source_ids = read_position_file(args.position_fn)
        binauralizer = SourceBinauralizer(use_hrtfs=args.use_hrtfs,
                                          cipic_dir=args.cipic_dir)
        pts = positions[source_ids[0]]
        if len(pts) > 1:
            src = MovingSource(mono, pts, int(rate))
            stereo = np.zeros((mono.shape[0], 2))
            while src.tic():
                binauralizer.binauralize_frame([src], stereo, src.cur_idx)
        else:
            stereo = binauralizer.binauralize(
                [PositionalSource(mono, pts[0], int(rate))])
    else:
        ambi, rate = load_wav(args.input_fn, args.rate)
        fmt = AmbiFormat(order=int(np.sqrt(ambi.shape[1]) - 1), sample_rate=int(rate))
        if args.method == "direct":
            stereo = DirectAmbisonicBinauralizer(fmt, method="pseudoinv").binauralize(ambi)
        else:
            stereo = AmbisonicBinauralizer(fmt, method=args.method,
                                           use_hrtfs=args.use_hrtfs,
                                           cipic_dir=args.cipic_dir).binauralize(ambi)

    stereo = stereo / (np.abs(stereo).max() + 1e-9) * 0.95
    save_wav(args.output_fn, stereo, int(rate))
    print(f"Wrote stereo {stereo.shape} to {args.output_fn}")


if __name__ == "__main__":
    main()
