"""Encode mono sources + trajectories into ambisonics (FOA+) wav
(sag-torch-encode; the port's counterpart of spatialaudiogen_tpu.cli.encode,
numpy and scipy).

Capability parity with reference pyutils/ambisonics/scripts/
encode_to_ambisonics(.py/_xyz.py): a position file describes one or more
sources (`src_id wav_fn phi nu r` header lines followed by `src_id phi nu r`
keypoints; sources without keypoints are ambient and mix into W only).
Encoding is vectorized over the whole trajectory (encoder.encode_moving)
instead of the reference's per-frame tic loop.

    python -m spatialaudiogen_tpu_torch.cli.encode POSITION_FN OUTPUT_WAV \
        [--ambi_order 1] [--rate 24000] [--base_dir DIR] [--overwrite]

With --xyz X Y Z the first argument is instead a mono wav encoded at that
fixed cartesian position (reference encode_to_ambisonics_xyz.py:11-20).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def encode_position_file(position_fn: str, ambi_order: int = 1, rate: int = 24000,
                         base_dir: str | None = None) -> np.ndarray:
    from spatialaudiogen_tpu_torch.ambisonics.encoder import AmbiEncoder
    from spatialaudiogen_tpu_torch.ambisonics.format import AmbiFormat
    from spatialaudiogen_tpu_torch.ambisonics.position import MovingSource
    from spatialaudiogen_tpu_torch.utils.io_audio import load_wav
    from spatialaudiogen_tpu_torch.utils.io_position import read_position_file

    positions, wav_fns, source_ids = read_position_file(position_fn)
    base_dir = base_dir or os.path.dirname(os.path.abspath(position_fn))

    signals = {}
    for sid in source_ids:
        fn = wav_fns.get(sid)
        assert fn is not None, f"source {sid} has no wav file in {position_fn}"
        if not os.path.isabs(fn):
            fn = os.path.join(base_dir, fn)
        mono, _ = load_wav(fn, rate)
        signals[sid] = mono[:, 0] if mono.ndim == 2 else mono

    fmt = AmbiFormat(order=ambi_order, sample_rate=rate)
    encoder = AmbiEncoder(fmt)
    moving = [MovingSource(signals[sid], positions[sid], rate)
              for sid in source_ids if len(positions[sid]) > 1]
    static_or_ambient = [sid for sid in source_ids if len(positions[sid]) <= 1]

    n_frames = max(s.size for s in signals.values())
    ambix = np.zeros((n_frames, fmt.num_channels))
    if moving:
        enc = encoder.encode_moving(moving).data
        ambix[: enc.shape[0]] += enc
    for sid in static_or_ambient:
        sig = signals[sid]
        if len(positions[sid]) == 1:
            from spatialaudiogen_tpu_torch.ambisonics.position import PositionalSource

            enc = encoder.encode(PositionalSource(sig, positions[sid][0], rate)).data
            ambix[: enc.shape[0]] += enc
        else:  # ambient: omni only
            ambix[: sig.size, 0] += sig
    peak = np.abs(ambix).max()
    if peak > 0:
        ambix = ambix / peak * 0.95
    return ambix


def encode_fixed_xyz(input_fn: str, xyz, ambi_order: int = 1,
                     rate: int | None = None):
    """Encode a mono wav at one fixed cartesian position (reference
    encode_to_ambisonics_xyz.py:11-20). rate=None keeps the wav's native
    rate, as the reference does. Returns (ambix, rate)."""
    from spatialaudiogen_tpu_torch.ambisonics.encoder import AmbiEncoder
    from spatialaudiogen_tpu_torch.ambisonics.format import AmbiFormat
    from spatialaudiogen_tpu_torch.ambisonics.position import (
        Position,
        PositionalSource,
    )
    from spatialaudiogen_tpu_torch.utils.io_audio import load_wav

    mono, in_rate = load_wav(input_fn, rate)
    if mono.ndim == 2:
        mono = mono[:, 0]
    pos = Position(*xyz, "cartesian")
    encoder = AmbiEncoder(AmbiFormat(order=ambi_order, sample_rate=int(in_rate)))
    return encoder.encode(PositionalSource(mono, pos, int(in_rate))).data, int(in_rate)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("position_fn")
    parser.add_argument("output_fn")
    parser.add_argument("--ambi_order", type=int, default=1)
    parser.add_argument("--rate", type=int, default=None,
                        help="resample rate (default: 24000 for position "
                             "files, the wav's native rate for --xyz, as in "
                             "the reference scripts)")
    parser.add_argument("--base_dir", default=None)
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--xyz", nargs=3, type=float, default=None,
                        metavar=("X", "Y", "Z"),
                        help="encode POSITION_FN (a mono wav) at this fixed "
                             "cartesian position instead")
    args = parser.parse_args(argv)
    if args.overwrite and os.path.exists(args.output_fn):
        os.remove(args.output_fn)
    assert not os.path.exists(args.output_fn), "output exists (use --overwrite)"

    from spatialaudiogen_tpu_torch.utils.io_audio import save_wav

    if args.xyz is not None:
        ambix, rate = encode_fixed_xyz(args.position_fn, args.xyz,
                                       args.ambi_order, args.rate)
    else:
        rate = args.rate or 24000
        ambix = encode_position_file(args.position_fn, args.ambi_order,
                                     rate, args.base_dir)
    save_wav(args.output_fn, ambix, rate)
    print(f"Wrote {ambix.shape} ambisonics to {args.output_fn}")


if __name__ == "__main__":
    main()
