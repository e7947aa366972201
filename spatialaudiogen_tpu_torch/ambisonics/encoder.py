"""Ambisonic encoding: project mono point sources onto SH channels (the
port's copy of spatialaudiogen_tpu.ambisonics.encoder, numpy only).

Parity with reference pyutils/ambisonics/encoder.py. Adds a vectorized
moving-source encoder (`encode_moving`) that replaces the per-frame
`encode_frame` loop with one batched SH evaluation + per-frame dot product.
"""

from __future__ import annotations

import numpy as np

from spatialaudiogen_tpu_torch.ambisonics.format import AmbiFormat, AmbisonicArray
from spatialaudiogen_tpu_torch.ambisonics.position import MovingSource, PositionalSource
from spatialaudiogen_tpu_torch.ambisonics.sh import sh_matrix_polar, spherical_harmonics_matrix


class AmbiEncoder:
    def __init__(self, ambi_format: AmbiFormat):
        self.format = ambi_format

    def encode(self, sources) -> AmbisonicArray:
        """Static sources: (T,) signals x SH matrix -> (T, num_channels).

        MovingSources are routed to encode_moving (and mixed lists are
        encoded per kind and summed). The reference (encoder.py:10-22)
        silently encodes a moving source at its *placeholder* position
        (0,0,0) unless the caller runs the tic() loop — a plain bug, fixed
        here per the repo convention.
        """
        if isinstance(sources, PositionalSource):
            sources = [sources]
        assert all(isinstance(s, PositionalSource) for s in sources)
        assert all(s.signal.ndim == 1 for s in sources)
        moving = [s for s in sources if isinstance(s, MovingSource)]
        if moving:
            out = self.encode_moving(moving)
            static = [s for s in sources if not isinstance(s, MovingSource)]
            if static:
                rest = self.encode(static).data
                n = min(out.data.shape[0], rest.shape[0])
                out = AmbisonicArray(out.data[:n] + rest[:n], self.format)
            return out
        fmt = self.format
        Y = spherical_harmonics_matrix([s.position for s in sources], fmt.order,
                                       fmt.ordering, fmt.normalization)
        sig = np.stack([s.signal for s in sources], axis=1)
        return AmbisonicArray(sig @ Y, self.format)

    def encode_frame(self, sources, ambi_array: AmbisonicArray, frame_no: int):
        """Single-frame encode for incremental use (reference encoder.py:24-34)."""
        if isinstance(sources, PositionalSource):
            sources = [sources]
        Y = spherical_harmonics_matrix([s.position for s in sources], self.format.order,
                                       self.format.ordering, self.format.normalization)
        sig = np.array([s.signal[frame_no] for s in sources]).reshape(-1, 1)
        ambi_array.data[frame_no] = (sig * Y).sum(axis=0)

    def encode_moving(self, sources) -> AmbisonicArray:
        """Moving sources, vectorized over time.

        Equivalent to ticking each MovingSource and calling encode_frame per
        frame, but evaluates the whole (T, num_channels) SH trajectory at once.
        """
        if isinstance(sources, MovingSource):
            sources = [sources]
        assert all(isinstance(s, MovingSource) for s in sources)
        fmt = self.format
        n_frames = min(s.nframes for s in sources)
        out = np.zeros((n_frames, fmt.num_channels))
        for src in sources:
            traj = src.trajectory()[:n_frames]          # (T, 3) polar
            Y = sh_matrix_polar(traj[:, 0], traj[:, 1], fmt.order,
                                fmt.ordering, fmt.normalization)  # (T, C)
            out += src.signal[:n_frames, None] * Y
        return AmbisonicArray(out, self.format)

    def encode_with_distance(self, sources) -> AmbisonicArray:
        """encode_v2 parity (reference encoder.py:36-55): delay + 1/(1+d) gain."""
        if isinstance(sources, PositionalSource):
            sources = [sources]
        radius = self.format.radius
        if radius > 0:
            assert all(s.position.r > radius for s in sources)
        for src in sources:
            if src.position.r > 0:
                dist = src.position.r - radius
                delay = int(dist / 343.0 * src.sample_rate)
                attenuation = 1.0 / (1.0 + dist)
                shifted = np.zeros_like(src.signal)
                if delay < src.signal.shape[0]:
                    shifted[delay:] = src.signal[: src.signal.shape[0] - delay]
                src.signal = shifted * attenuation
                src.position.set_radius(radius)
        return self.encode(sources)
