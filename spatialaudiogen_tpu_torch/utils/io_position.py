"""Source-position trajectory files.

Format parity with reference pyutils/iolib/position.py:6-43: each line is
`<source_id> <t|-> <phi> <nu> <r> [wav_fn]`-style records; concretely the
reference stores per-source keypoint lines `src_id phi nu r` plus an optional
header mapping source ids to wav files. We keep its simple contract:

    read_position_file(fn) -> (positions, wav_fns, source_ids)

where positions[src_id] is a list of Position keypoints in file order.
"""

from __future__ import annotations

from spatialaudiogen_tpu_torch.ambisonics.position import Position


def read_position_file(fn: str):
    positions: dict = {}
    wav_fns: dict = {}
    source_ids: list = []
    for line in open(fn):
        parts = line.strip().split()
        if not parts or parts[0].startswith("#"):
            continue
        if len(parts) >= 5 and not _is_float(parts[1]):
            # "src_id wav_fn phi nu r" header-style line
            src, wav, vals = parts[0], parts[1], parts[2:5]
            wav_fns[src] = wav
        elif len(parts) >= 4:
            src, vals = parts[0], parts[1:4]
        else:
            # bare "phi nu r" line -> single implicit source "0"
            src, vals = "0", parts[0:3]
        if src not in positions:
            positions[src] = []
            source_ids.append(src)
        positions[src].append(Position(float(vals[0]), float(vals[1]), float(vals[2]), "polar"))
    return positions, wav_fns, source_ids


def save_position_file(fn: str, positions: dict):
    with open(fn, "w") as f:
        for src, plist in positions.items():
            for p in plist:
                f.write(f"{src} {p.phi} {p.nu} {p.r}\n")


def _is_float(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


class PositionReader:
    """Interpolating reader over a trajectory file (reference position.py:46-115).

    get(t) returns each source's polar coords at time t, with azimuth
    wraparound-aware interpolation between the two nearest keypoints.
    """

    def __init__(self, fn: str, rate: float = 10.0, duration: float | None = None):
        import numpy as np

        self.positions, _, self.source_ids = read_position_file(fn)
        self.rate = rate
        self.duration = duration
        self._np = np

    def get(self, t: float):
        import numpy as np

        out = []
        for src in self.source_ids:
            pts = self.positions[src]
            if len(pts) == 1:
                out.append(pts[0].coords("polar"))
                continue
            total = self.duration if self.duration is not None else len(pts) / self.rate
            ts = np.linspace(0, total, len(pts))
            idx = int(np.clip(np.searchsorted(ts, t) - 1, 0, len(pts) - 2))
            alpha = (t - ts[idx]) / (ts[idx + 1] - ts[idx])
            a = pts[idx].coords("polar")
            b = pts[idx + 1].coords("polar")
            dphi = b[0] - a[0]
            # azimuth wraparound: go the short way around the circle
            if dphi > np.pi:
                dphi -= 2 * np.pi
            elif dphi < -np.pi:
                dphi += 2 * np.pi
            phi = a[0] + alpha * dphi
            out.append(np.array([phi, a[1] + alpha * (b[1] - a[1]), a[2] + alpha * (b[2] - a[2])]))
        return out
