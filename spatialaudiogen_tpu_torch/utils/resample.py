"""Polyphase resampling (the port's copy of spatialaudiogen_tpu.utils.resample)."""

from __future__ import annotations

from fractions import Fraction

import numpy as np


def resample(data: np.ndarray, in_rate: int, out_rate: int, axis: int = 0) -> np.ndarray:
    """High-quality rational-ratio polyphase resample along `axis`."""
    if int(in_rate) == int(out_rate):
        return data
    from scipy.signal import resample_poly

    frac = Fraction(int(out_rate), int(in_rate)).limit_denominator(1 << 16)
    return resample_poly(data, frac.numerator, frac.denominator, axis=axis)
