"""Ambisonics DSP library on the host (the port's copy of
spatialaudiogen_tpu.ambisonics, numpy and scipy): AmbiFormat, channel
orderings (ACN/SID/FuMa), normalizations (SN3D/N3D/MaxN), real spherical
harmonics, encoder/decoder, rotations, binauralizers, spherical power maps
and the EMD spatial metric. It exports what the JAX package's exports.
"""

from spatialaudiogen_tpu_torch.ambisonics.format import (
    AmbiFormat,
    AmbisonicArray,
    CHANNEL_ORDERING,
    NORMALIZATION,
    DEFAULT_ORDERING,
    DEFAULT_NORMALIZATION,
    degree_order_to_index,
    index_to_degree_order,
    convert_ordering,
    normalization_factor,
)
from spatialaudiogen_tpu_torch.ambisonics.sh import (
    spherical_harmonic_mn,
    spherical_harmonics,
    spherical_harmonics_matrix,
    sh_matrix_polar,
)
from spatialaudiogen_tpu_torch.ambisonics.position import (
    Position,
    PositionalSource,
    MovingSource,
)
from spatialaudiogen_tpu_torch.ambisonics.encoder import AmbiEncoder
from spatialaudiogen_tpu_torch.ambisonics.decoder import AmbiDecoder
from spatialaudiogen_tpu_torch.ambisonics.rotation import foa_rotation_matrix, rotate_foa
