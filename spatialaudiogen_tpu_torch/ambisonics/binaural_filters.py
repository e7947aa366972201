"""Embedded ambisonic binaural decode filters (no external HRTF data; the
port's copy of spatialaudiogen_tpu.ambisonics.binaural_filters).

The reference vendors Google's symmetric-ambisonic-binaural-decoder wav set
(reference 3rd-party/spatial-media/spatial-audio/: one FIR per ambisonic
channel, applied directly to the ambiX mix and summed into L/R — see its
README "symmetric ambisonic binaural decoder" signal flow). Those FIRs are
measured SADIE KU100 data this repo does not ship; the same signal flow is
served here by filters DERIVED from first principles at import cost only:

  t-design speaker layout (ambisonics/tdesigns.py; the 8-point CUBE for
  order 1 — the same configuration Google's decoder uses, cube.config) ->
  pseudoinverse ambisonic decode matrix -> per-speaker spherical-head
  HRIRs (Brown-Duda structural model: Woodworth ITD + one-pole/one-zero
  head-shadow filter) -> composite per-channel FIRs

      F_ear[ch] = sum_spk D[ch, spk] * hrir_ear(spk_direction)

so binauralize(ambi) == decode-to-speakers + per-speaker binauralization,
collapsed into 2*(order+1)^2 fixed 256-tap FIRs (the reference set's
length, with its half-hann fade-out). This is the works-out-of-the-box
HRTF path for `sag-torch-binauralize --use_hrtfs` when no CIPIC directory is
given; a measured HRTF database still sounds better — point --cipic_dir
at one for the Convolvotron path (ambisonics/binauralizer.py).

A structural model is not a measured head: expect correct ITD/ILD and
head-shadow coloration, but no pinna notches. Filters are deterministic,
cached per (order, rate, taps).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from spatialaudiogen_tpu_torch.ambisonics.decoder import AmbiDecoder
from spatialaudiogen_tpu_torch.ambisonics.format import AmbiFormat
from spatialaudiogen_tpu_torch.ambisonics.position import Position
from spatialaudiogen_tpu_torch.ambisonics.tdesigns import get_tdesign

HEAD_RADIUS = 0.0875        # m (Brown-Duda average head)
SPEED_OF_SOUND = 343.0      # m/s
DEFAULT_TAPS = 256          # reference SADIE set length at 48 kHz
_FADE = 16                  # half-hann fade-out taps (reference spec)
_EAR_AXES = {"left": np.array([0.0, 1.0, 0.0]),   # head coords: x front,
             "right": np.array([0.0, -1.0, 0.0])}  # y left, z up


def _head_shadow(freqs: np.ndarray, theta_inc_deg: float) -> np.ndarray:
    """Brown & Duda (1998) one-pole/one-zero head-shadow response.

    H(w) = (1 + j*alpha*w/(2 w0)) / (1 + j*w/(2 w0)), w0 = c/a. alpha runs
    from ~2 at the ipsilateral pole (high-shelf boost) to alpha_min on the
    shadowed side (high-shelf cut); DC gain is 1 for every direction.
    """
    w = 2.0 * np.pi * freqs
    w0 = SPEED_OF_SOUND / HEAD_RADIUS
    alpha_min, theta_min = 0.1, 150.0
    alpha = (1.0 + alpha_min / 2.0) + (1.0 - alpha_min / 2.0) * np.cos(
        np.pi * theta_inc_deg / theta_min)
    return (1.0 + 1j * alpha * w / (2.0 * w0)) / (1.0 + 1j * w / (2.0 * w0))


def _woodworth_delay(theta_inc_rad: float) -> float:
    """Seconds of arrival offset vs the head center (negative = earlier):
    straight-line until the ear falls into shadow, arc length after."""
    a_c = HEAD_RADIUS / SPEED_OF_SOUND
    if theta_inc_rad < np.pi / 2.0:
        return -a_c * np.cos(theta_inc_rad)
    return a_c * (theta_inc_rad - np.pi / 2.0)


def spherical_head_hrir(direction, sample_rate: int = 48000,
                        n_taps: int = DEFAULT_TAPS):
    """(left, right) length-n_taps FIRs for a far-field source at unit
    vector `direction` (head coords). Built in the frequency domain
    (host-side numpy FFT; the TPU never sees this) so fractional ITDs are
    exact phase ramps, then faded out half-hann like the reference set."""
    d = np.asarray(direction, np.float64)
    d = d / np.linalg.norm(d)
    base_delay = (n_taps // 8) / float(sample_rate)  # causal margin
    freqs = np.fft.rfftfreq(n_taps, 1.0 / sample_rate)
    out = []
    for ear in ("left", "right"):
        cos_inc = float(np.clip(np.dot(d, _EAR_AXES[ear]), -1.0, 1.0))
        theta = float(np.arccos(cos_inc))
        delay = _woodworth_delay(theta) + base_delay
        resp = _head_shadow(freqs, np.degrees(theta)) * np.exp(
            -2j * np.pi * freqs * delay)
        h = np.fft.irfft(resp, n=n_taps)
        h[-_FADE:] *= np.hanning(2 * _FADE)[_FADE:]
        out.append(h)
    return out[0], out[1]


@lru_cache(maxsize=8)
def _decoder_filters_cached(order: int, sample_rate: int, n_taps: int,
                            ordering: str, normalization: str) -> np.ndarray:
    n_speakers = 8 if order == 1 else None  # CUBE, Google's FOA layout
    pts = get_tdesign(order, n_speakers)
    fmt = AmbiFormat(order=order, sample_rate=sample_rate,
                     ordering=ordering, normalization=normalization)
    dec = AmbiDecoder([Position(x, y, z, "cartesian") for x, y, z in pts],
                      fmt, method="pseudoinv")
    D = dec.pinv  # (num_channels, n_speakers): ambi @ D -> speaker gains
    filters = np.zeros((2, fmt.num_channels, n_taps))
    for s, p in enumerate(pts):
        left, right = spherical_head_hrir(p, sample_rate, n_taps)
        filters[0] += D[:, s][:, None] * left[None, :]
        filters[1] += D[:, s][:, None] * right[None, :]
    return filters


def make_binaural_decoder_filters(order: int = 1, sample_rate: int = 48000,
                                  n_taps: int = DEFAULT_TAPS,
                                  ordering: str = "ACN",
                                  normalization: str = "SN3D") -> np.ndarray:
    """(2, (order+1)^2, n_taps) composite decode FIRs: [ear, channel, tap].
    Convolve each ambisonic channel with its per-ear filter and sum — the
    reference set's exact usage (spatial-audio README signal flow)."""
    return _decoder_filters_cached(order, sample_rate, n_taps,
                                   ordering, normalization).copy()


class AmbisonicFilterBinauralizer:
    """Binauralize an ambisonic mix through the embedded decode FIRs.

    Drop-in alternative to AmbisonicBinauralizer(use_hrtfs=True) that needs
    no CIPIC data: same decode-then-binauralize math, precollapsed into
    2*C convolutions.
    """

    def __init__(self, ambi_format: AmbiFormat, n_taps: int = DEFAULT_TAPS):
        self.fmt = ambi_format
        self.filters = make_binaural_decoder_filters(
            ambi_format.order, ambi_format.sample_rate, n_taps,
            ambi_format.ordering, ambi_format.normalization)

    def binauralize(self, ambi: np.ndarray) -> np.ndarray:
        """(T, num_channels) ambisonics -> (T, 2) stereo."""
        from scipy.signal import fftconvolve

        ambi = np.asarray(ambi)
        assert ambi.ndim == 2 and ambi.shape[1] == self.fmt.num_channels, \
            (ambi.shape, self.fmt.num_channels)
        n = ambi.shape[0]
        stereo = np.zeros((n, 2))
        for ear in (0, 1):
            # one batched FFT convolution over all channels, summed
            full = fftconvolve(ambi, self.filters[ear].T, mode="full", axes=0)
            stereo[:, ear] = full[:n].sum(axis=1) if full.ndim == 2 else full[:n]
        return stereo
