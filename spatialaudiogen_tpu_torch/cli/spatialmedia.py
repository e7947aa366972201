"""Standalone spatial-media metadata tool (print / inject; the port's copy
of spatialaudiogen_tpu.cli.spatialmedia).

CLI parity with the vendored spatial-media package the reference shells out
to (myutils.py:304-311; 3rd-party/spatial-media/spatialmedia/__main__.py):
by default prints the spatial metadata of each file; with -i/--inject,
writes a copy of the first file with spherical-video V1 XML (+ optional
SA3D spatial audio) injected.

    python -m spatialaudiogen_tpu_torch.cli.spatialmedia FILE [FILE...]
    python -m spatialaudiogen_tpu_torch.cli.spatialmedia -i [--stereo none] \
        [--spatial-audio] [--ambi_order 1] IN.mp4 OUT.mp4
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-i", "--inject", action="store_true",
                        help="inject metadata into the first file, writing "
                             "the result to the second")
    parser.add_argument("-s", "--stereo", default="none", dest="stereo_mode",
                        choices=["none", "top-bottom", "left-right"],
                        help="stereo mode for the spherical XML")
    parser.add_argument("-a", "--spatial-audio", action="store_true",
                        dest="spatial_audio",
                        help="also inject an SA3D box (periphonic ambisonics, "
                             "ACN/SN3D) into every audio track")
    parser.add_argument("--ambi_order", type=int, default=1,
                        help="ambisonics order recorded in the SA3D box")
    parser.add_argument("file", nargs="+", help="input/output files")
    args = parser.parse_args(argv)

    from spatialaudiogen_tpu_torch.deploy.sa3d import describe_file, inject_file

    if args.inject:
        if len(args.file) != 2:
            parser.error(
                "injecting metadata requires exactly an input file and an "
                "output file")
        inject_file(args.file[0], args.file[1],
                    spatial_audio=args.spatial_audio, spherical_video=True,
                    order=args.ambi_order, stereo_mode=args.stereo_mode)
        print(f"Injected spatial metadata: {args.file[0]} -> {args.file[1]}")
        return

    for fn in args.file:
        for line in describe_file(fn):
            print(line)


if __name__ == "__main__":
    main()
