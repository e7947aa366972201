"""Binauralization: render point sources / ambisonics to stereo (the port's
copy of spatialaudiogen_tpu.ambisonics.binauralizer, numpy and scipy).

Parity with reference pyutils/ambisonics/binauralizer.py:
  * VirtualStereoMic     — distance delay + 1/(1+d) attenuation per ear
  * Convolvotron         — CIPIC HRIR convolution (vectorized FFT convolve)
  * SourceBinauralizer   — dispatches between the two
  * AmbisonicBinauralizer— decode to a speaker ring/t-design, then binauralize
  * DirectAmbisonicBinauralizer — decode straight at the two ear positions
"""

from __future__ import annotations

import numpy as np

from spatialaudiogen_tpu_torch.ambisonics.decoder import AmbiDecoder
from spatialaudiogen_tpu_torch.ambisonics.format import AmbiFormat
from spatialaudiogen_tpu_torch.ambisonics.hrir import CipicHRIR
from spatialaudiogen_tpu_torch.ambisonics.position import Position, PositionalSource
from spatialaudiogen_tpu_torch.ambisonics.tdesigns import get_tdesign

SPEED_OF_SOUND = 343.0  # m/s


def _delayed(signal: np.ndarray, delay: int) -> np.ndarray:
    out = np.zeros_like(signal)
    if delay < signal.shape[0]:
        out[delay:] = signal[: signal.shape[0] - delay]
    return out


class VirtualStereoMic:
    def __init__(self, radius: float = 0.1):
        self.radius = radius
        self.lmic_pos = Position(0, radius, 0, "cartesian")
        self.rmic_pos = Position(0, -radius, 0, "cartesian")

    def binauralize(self, sources) -> np.ndarray:
        if isinstance(sources, PositionalSource):
            sources = [sources]
        l_signal, r_signal = 0.0, 0.0
        for src in sources:
            p = src.position.coords("cartesian")
            l_dist = float(np.linalg.norm(p - self.lmic_pos.coords("cartesian")))
            r_dist = float(np.linalg.norm(p - self.rmic_pos.coords("cartesian")))
            l_delay = int(l_dist / SPEED_OF_SOUND * src.sample_rate)
            r_delay = int(r_dist / SPEED_OF_SOUND * src.sample_rate)
            l_signal = l_signal + _delayed(src.signal, l_delay) / (1.0 + l_dist) / len(sources)
            r_signal = r_signal + _delayed(src.signal, r_delay) / (1.0 + r_dist) / len(sources)
        return np.stack((l_signal, r_signal), axis=1)

    def binauralize_frame(self, sources, output: np.ndarray, frame_no: int):
        if isinstance(sources, PositionalSource):
            sources = [sources]
        for src in sources:
            p = src.position.coords("cartesian")
            for ch, mic in enumerate((self.lmic_pos, self.rmic_pos)):
                dist = float(np.linalg.norm(p - mic.coords("cartesian")))
                delay = int(dist / SPEED_OF_SOUND * src.sample_rate)
                if frame_no - delay >= 0:
                    output[frame_no, ch] += src.signal[frame_no - delay] / (1.0 + dist) / len(sources)


class Convolvotron:
    def __init__(self, cipic_dir: str):
        self.hrir_db = CipicHRIR(cipic_dir)

    def binauralize(self, sources) -> np.ndarray:
        from scipy.signal import fftconvolve

        if isinstance(sources, PositionalSource):
            sources = [sources]
        num_frames = max(src.signal.shape[0] for src in sources)
        stereo = np.zeros((num_frames, 2))
        for src in sources:
            left_hrir, right_hrir = self.hrir_db.get_closest(src.position)[1:]
            left = fftconvolve(src.signal, np.flip(left_hrir), mode="valid")
            right = fftconvolve(src.signal, np.flip(right_hrir), mode="valid")
            i_start = left_hrir.shape[0] - 1
            stereo[i_start:i_start + left.shape[0], 0] += left
            stereo[i_start:i_start + right.shape[0], 1] += right
        return stereo

    def binauralize_frame(self, sources, output: np.ndarray, frame_no: int):
        if isinstance(sources, PositionalSource):
            sources = [sources]
        for src in sources:
            left_hrir, right_hrir = self.hrir_db.get_closest(src.position)[1:]
            i_start = frame_no - left_hrir.size + 1 if frame_no >= left_hrir.size else 0
            i_range = frame_no + 1 - i_start
            output[frame_no, 0] = (src.signal[i_start:frame_no + 1] * left_hrir[-i_range:]).sum()
            output[frame_no, 1] = (src.signal[i_start:frame_no + 1] * right_hrir[-i_range:]).sum()


class SourceBinauralizer:
    def __init__(self, use_hrtfs: bool = True, cipic_dir: str | None = None):
        self.use_hrtfs = use_hrtfs
        if use_hrtfs:
            self.convolvotron = Convolvotron(cipic_dir)
        else:
            self.stereo_mic = VirtualStereoMic()

    def _impl(self):
        return self.convolvotron if self.use_hrtfs else self.stereo_mic

    def binauralize(self, sources) -> np.ndarray:
        if isinstance(sources, PositionalSource):
            sources = [sources]
        assert all(isinstance(s, PositionalSource) for s in sources)
        assert all(s.sample_rate == sources[0].sample_rate for s in sources)
        return self._impl().binauralize(sources)

    def binauralize_frame(self, sources, output, frame_no):
        if isinstance(sources, PositionalSource):
            sources = [sources]
        return self._impl().binauralize_frame(sources, output, frame_no)


class AmbisonicBinauralizer:
    """Decode ambisonics to speakers, then binauralize the speaker feeds.

    use_hrtfs with NO cipic_dir falls back to the embedded spherical-head
    decode filters (ambisonics/binaural_filters.py) — the reference's
    analogue is the vendored Google symmetric-ambisonic-binaural-decoder
    wav set (3rd-party/spatial-media/spatial-audio/), which gave HRTF
    binauralization without user-supplied data; here the filter set is
    derived rather than shipped.
    """

    def __init__(self, ambi_format: AmbiFormat, method: str = "projection",
                 use_hrtfs: bool = False, cipic_dir: str | None = None):
        self._filter_bin = None
        if use_hrtfs and cipic_dir is None:
            from spatialaudiogen_tpu_torch.ambisonics.binaural_filters import (
                AmbisonicFilterBinauralizer)

            self._filter_bin = AmbisonicFilterBinauralizer(ambi_format)
            self.fmt = ambi_format
            return
        self.source_bin = SourceBinauralizer(use_hrtfs=use_hrtfs, cipic_dir=cipic_dir)
        self.fmt = ambi_format
        self.method = method
        if method == "pseudoinv":
            pts = get_tdesign(self.fmt.order)
            self.speaker_pos = [Position(x, y, z, "cartesian") for x, y, z in pts]
            for p in self.speaker_pos:
                p.set_radius(self.fmt.radius)
        elif method == "projection":
            n = 2 * self.fmt.num_channels
            phis = (2.0 * np.arange(n) / float(n) - 1.0) * np.pi
            self.speaker_pos = [Position(phi, 0, self.fmt.radius, "polar") for phi in phis]
        else:
            raise ValueError("Unknown decoding method. Options: projection and pseudoinv")
        self.n_speakers = len(self.speaker_pos)
        self.ambi_decoder = AmbiDecoder(self.speaker_pos, self.fmt, method=method)

    def binauralize(self, ambi: np.ndarray) -> np.ndarray:
        if self._filter_bin is not None:
            return self._filter_bin.binauralize(ambi)
        speakers = self.ambi_decoder.decode(ambi)
        sources = [PositionalSource(speakers[:, i], self.speaker_pos[i], self.fmt.sample_rate)
                   for i in range(self.n_speakers)]
        return self.source_bin.binauralize(sources)


class DirectAmbisonicBinauralizer:
    """Decode ambisonics directly at the two ear positions."""

    def __init__(self, ambi_format: AmbiFormat, method: str = "projection"):
        self.fmt = ambi_format
        self.ear_pos = [Position(0, 0.1, 0, "cartesian"), Position(0, -0.1, 0, "cartesian")]
        self.ambi_decoder = AmbiDecoder(self.ear_pos, self.fmt, method=method)

    def binauralize(self, ambi: np.ndarray) -> np.ndarray:
        return self.ambi_decoder.decode(ambi)
