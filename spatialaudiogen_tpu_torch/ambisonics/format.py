"""Ambisonic channel formats: orderings, normalizations, conversions.

Semantics match the reference library (pyutils/ambisonics/common.py:14-148):
ACN / SID / Furse-Malham channel orderings and SN3D / N3D / MaxN
normalization conventions, default ACN+SN3D (the "ambiX" format).
"""

from __future__ import annotations

import dataclasses
from math import factorial, pi, sqrt

import numpy as np

CHANNEL_ORDERING = ("FURSE_MALHAM", "SID", "ACN")
NORMALIZATION = ("MAX_N", "SN3D", "N3D")
DEFAULT_ORDERING = "ACN"
DEFAULT_NORMALIZATION = "SN3D"
DEFAULT_RATE = 44100
DEFAULT_RADIUS = 1.0
DEFAULT_ORDER = 1


@dataclasses.dataclass
class AmbiFormat:
    """Describes an ambisonic stream: order, rate, ordering and normalization."""

    order: int = DEFAULT_ORDER
    sample_rate: int = DEFAULT_RATE
    radius: float = DEFAULT_RADIUS
    ordering: str = DEFAULT_ORDERING
    normalization: str = DEFAULT_NORMALIZATION

    def __post_init__(self):
        assert self.ordering in CHANNEL_ORDERING
        assert self.normalization in NORMALIZATION

    @property
    def num_channels(self) -> int:
        return int((self.order + 1) ** 2)


def _within_order_layout(order: int, ordering: str) -> list:
    """idx_order[m + order] = within-order slot of degree m.

    Same layouts as reference common.py:62-88: SID runs +n,-n,...,+1,-1,0;
    FuMa runs 0,+1,-1,...,+n,-n (with the order-1 special case W,X,Y,Z).
    """
    n = order
    if ordering == "SID":
        return [1 + i * 2 for i in range(n)] + [n * 2] + list(reversed([i * 2 for i in range(n)]))
    # FURSE_MALHAM
    if n == 1:
        return [1, 2, 0]
    return list(reversed([2 * (i + 1) for i in range(n)])) + [0] + [1 + i * 2 for i in range(n)]


def degree_order_to_index(order: int, degree: int, ordering: str = DEFAULT_ORDERING) -> int:
    """Map (order n, degree m) to a channel index under the given ordering."""
    assert -order <= degree <= order
    assert ordering in CHANNEL_ORDERING
    if ordering == "ACN":
        return order * (order + 1) + degree
    return _within_order_layout(order, ordering)[degree + order] + order ** 2


def index_to_degree_order(index: int, ordering: str = DEFAULT_ORDERING) -> tuple[int, int]:
    """Inverse of degree_order_to_index.

    Note: the reference's inverse (common.py:91-118) applies FuMa's unrolling
    to SID, which does not invert its own SID forward mapping; here the
    inverse is derived from the same layout table so the roundtrip is exact
    for every ordering.
    """
    assert ordering in CHANNEL_ORDERING
    order = int(sqrt(index))
    index -= order ** 2
    if ordering == "ACN":
        return order, index - order
    layout = _within_order_layout(order, ordering)
    return order, layout.index(index) - order


def convert_ordering(index: int, orig_ordering: str, dest_ordering: str) -> int:
    """Index in `dest_ordering` of the channel stored at `index` in `orig_ordering`."""
    if dest_ordering == orig_ordering:
        return index
    n, m = index_to_degree_order(index, orig_ordering)
    return degree_order_to_index(n, m, dest_ordering)


def ordering_permutation(num_channels: int, orig_ordering: str, dest_ordering: str) -> np.ndarray:
    """Permutation P such that data[:, P] converts orig->dest ordering.

    Matches the mapping construction at reference common.py:47-50:
    P[i] = index in orig of the channel that belongs at slot i of dest.
    """
    return np.array(
        [convert_ordering(i, dest_ordering, orig_ordering) for i in range(num_channels)],
        dtype=np.int64,
    )


def normalization_factor(index: int, ordering: str = DEFAULT_ORDERING,
                         normalization: str = DEFAULT_NORMALIZATION) -> float:
    """Per-channel gain of `normalization` relative to N3D-without-4pi baseline.

    Same factors as reference common.py:121-148.
    """
    assert ordering in CHANNEL_ORDERING
    assert normalization in NORMALIZATION
    n, m = index_to_degree_order(index, ordering)

    def sn3d(n, m):
        return sqrt((2.0 - float(m == 0)) * float(factorial(n - abs(m))) / float(factorial(n + abs(m))))

    if normalization == "SN3D":
        return sn3d(n, m)
    if normalization == "N3D":
        return sn3d(n, m) * sqrt((2 * n + 1) / (4.0 * pi))
    # MAX_N (defined up to 3rd order)
    assert n <= 3
    if n == 0:
        return 1 / sqrt(2.0)
    if n == 1:
        return 1.0
    if n == 2:
        return 1.0 if m == 0 else 2.0 / sqrt(3.0)
    return 1.0 if m == 0 else (sqrt(45.0 / 32) if m in (1, -1) else 3.0 / sqrt(5.0))


def normalization_factors(num_channels: int, ordering: str = DEFAULT_ORDERING,
                          normalization: str = DEFAULT_NORMALIZATION) -> np.ndarray:
    return np.array(
        [normalization_factor(i, ordering, normalization) for i in range(num_channels)],
        dtype=np.float64,
    )


class AmbisonicArray:
    """An ambisonic signal (frames, channels) + its format, with conversions.

    Mirrors reference common.py:29-59 (rate / ordering / normalization
    conversion) using vectorized numpy and a polyphase resampler.
    """

    def __init__(self, data: np.ndarray, ambi_format: AmbiFormat | None = None):
        self.data = data
        self.format = ambi_format if ambi_format is not None else AmbiFormat()

    def convert(self, sample_rate=None, ordering=None, normalization=None):
        assert sample_rate is not None or ordering is not None or normalization is not None
        n = self.format.num_channels

        if sample_rate is not None and sample_rate != self.format.sample_rate:
            from spatialaudiogen_tpu_torch.utils.resample import resample as _resample
            data = _resample(self.data, self.format.sample_rate, sample_rate)
            self.format.sample_rate = sample_rate
        else:
            data = np.copy(self.data)

        if ordering is not None and ordering != self.format.ordering:
            perm = ordering_permutation(n, self.format.ordering, ordering)
            data = data[:, perm]
            self.format.ordering = ordering

        if normalization is not None and normalization != self.format.normalization:
            c_out = normalization_factors(n, self.format.ordering, normalization)
            c_in = normalization_factors(n, self.format.ordering, self.format.normalization)
            data = data * (c_out / c_in).reshape((1, -1))
            self.format.normalization = normalization

        self.data = data
        return self
