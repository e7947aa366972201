"""Encode sources to ambisonics, then binauralize — one shot
(sag-torch-encode-and-binauralize; the port's counterpart of
spatialaudiogen_tpu.cli.encode_and_binauralize, numpy and scipy).

Parity with reference scripts/encode_and_binauralize(.py/_xyz.py).

    python -m spatialaudiogen_tpu_torch.cli.encode_and_binauralize POSITION_FN \
        OUT_PREFIX [--ambi_order 1] [--rate 24000] [--method projection]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("position_fn")
    parser.add_argument("out_prefix")
    parser.add_argument("--ambi_order", type=int, default=1)
    parser.add_argument("--rate", type=int, default=None,
                        help="resample rate (default: 24000 for position "
                             "files, native rate for --xyz)")
    parser.add_argument("--base_dir", default=None)
    parser.add_argument("--method", default="projection",
                        choices=["projection", "pseudoinv", "direct"])
    parser.add_argument("--xyz", nargs=3, type=float, default=None,
                        metavar=("X", "Y", "Z"),
                        help="encode POSITION_FN (a mono wav) at this fixed "
                             "cartesian position, then binauralize "
                             "(reference encode_and_binauralize_xyz.py:12-25)")
    args = parser.parse_args(argv)

    from spatialaudiogen_tpu_torch.ambisonics.binauralizer import (
        AmbisonicBinauralizer,
        DirectAmbisonicBinauralizer,
    )
    from spatialaudiogen_tpu_torch.ambisonics.format import AmbiFormat
    from spatialaudiogen_tpu_torch.cli.encode import encode_position_file
    from spatialaudiogen_tpu_torch.utils.io_audio import save_wav

    if args.xyz is not None:
        from spatialaudiogen_tpu_torch.cli.encode import encode_fixed_xyz

        ambix, rate = encode_fixed_xyz(args.position_fn, args.xyz,
                                       args.ambi_order, args.rate)
    else:
        rate = args.rate or 24000
        ambix = encode_position_file(args.position_fn, args.ambi_order,
                                     rate, args.base_dir)
    save_wav(args.out_prefix + "-ambix.wav", ambix, rate)

    fmt = AmbiFormat(order=args.ambi_order, sample_rate=rate)
    if args.method == "direct":
        stereo = DirectAmbisonicBinauralizer(fmt, method="pseudoinv").binauralize(ambix)
    else:
        stereo = AmbisonicBinauralizer(fmt, method=args.method).binauralize(ambix)
    stereo = stereo / (np.abs(stereo).max() + 1e-9) * 0.95
    save_wav(args.out_prefix + "-stereo.wav", stereo, rate)
    print(f"Wrote {args.out_prefix}-ambix.wav and {args.out_prefix}-stereo.wav")


if __name__ == "__main__":
    main()
