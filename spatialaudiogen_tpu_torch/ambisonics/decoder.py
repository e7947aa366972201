"""Ambisonic decoding to loudspeaker/grid signals.

Parity with reference pyutils/ambisonics/decoder.py: 'projection'
(transpose of the SH matrix) or 'pseudoinv' decoding. Accepts either
Position lists or raw (phi, nu) arrays for grid decodes.
"""

from __future__ import annotations

import numpy as np

from spatialaudiogen_tpu_torch.ambisonics.format import AmbiFormat
from spatialaudiogen_tpu_torch.ambisonics.position import Position
from spatialaudiogen_tpu_torch.ambisonics.sh import sh_matrix_polar, spherical_harmonics_matrix

DECODING_METHODS = ("projection", "pseudoinv")
DEFAULT_DECODING = "projection"


class AmbiDecoder:
    def __init__(self, speakers_pos, ambi_format: AmbiFormat, method: str = DEFAULT_DECODING):
        assert method in DECODING_METHODS
        if isinstance(speakers_pos, Position):
            speakers_pos = [speakers_pos]
        if isinstance(speakers_pos, (list, tuple)) and speakers_pos and isinstance(speakers_pos[0], Position):
            assert all(isinstance(p, Position) for p in speakers_pos)
            self.sph_mat = spherical_harmonics_matrix(
                speakers_pos, ambi_format.order, ambi_format.ordering, ambi_format.normalization)
        else:
            phi, nu = speakers_pos  # raw angle arrays
            self.sph_mat = sh_matrix_polar(phi, nu, ambi_format.order,
                                           ambi_format.ordering, ambi_format.normalization)
        self.speakers_pos = speakers_pos
        self.method = method
        if method == "pseudoinv":
            self.pinv = np.linalg.pinv(self.sph_mat)

    def decode(self, ambi: np.ndarray) -> np.ndarray:
        """(T, num_channels) -> (T, num_speakers)."""
        if self.method == "projection":
            return ambi @ self.sph_mat.T
        return ambi @ self.pinv
