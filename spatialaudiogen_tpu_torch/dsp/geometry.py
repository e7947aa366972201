"""Window/crop index arithmetic of the SptAudioGen model, bit-mirrored
(the port's copy of spatialaudiogen_tpu.dsp.geometry; tests hold the two
equal).

The reference computes its STFT crops with Python-2 arithmetic and magic
constants (model.py:161-172, 313-324, 344-348). Checkpoint parity requires
reproducing those indices exactly, including py2 `/` semantics (int/int
floors, int/float floats) and float-to-int truncation. This module is the
single source of truth for every index the model uses; everything is plain
Python ints.

Defaults (48 kHz, 1 s context, 0.1 s prediction, 1024 window):
  wind_size=1024, n_frames(stft)=200, encoder crop [46:173) -> 127 frames,
  mask stft crop [89:117) -> 28 frames, deconv crop [43:71),
  istft output crop [448:5248) -> 4800 samples.
"""

from __future__ import annotations

import dataclasses

import numpy as np

INP_DIM = 95  # encoder time receptive field in STFT frames (model.py:166)
N_OVERLAP = 4  # model STFT overlap factor (model.py:369)


@dataclasses.dataclass(frozen=True)
class ModelGeometry:
    ambi_order: int = 1
    audio_rate: int = 48000
    video_rate: int = 10
    context: float = 1.0
    sample_duration: float = 0.1
    fft_window: float = 0.025  # seconds (SEP_FFT_WINDOW_DEF)

    def __post_init__(self):
        assert self.audio_rate % self.video_rate == 0

    # --- basic sizes (model.py:35-60) ---
    @property
    def num_ambi_channels(self) -> int:
        return sum(2 * i + 1 for i in range(self.ambi_order + 1))

    @property
    def num_in_channels(self) -> int:
        return self.ambi_order ** 2

    @property
    def num_out_channels(self) -> int:
        return (self.ambi_order + 1) ** 2 - self.ambi_order ** 2

    @property
    def snd_contx(self) -> int:
        return int(self.context * self.audio_rate)

    @property
    def snd_dur(self) -> int:
        return int(self.sample_duration * self.audio_rate)

    @property
    def snd_size(self) -> int:
        """Model input length in samples (context + duration - 1)."""
        return self.snd_contx + self.snd_dur - 1

    @property
    def vid_dur(self) -> int:
        # Tolerance-round before truncating: 2.9 * 10 == 28.999999999999996
        # must be 29 frames, matching the validity check in
        # SptAudioGenConfig.__post_init__ (one rule for both places).
        v = self.sample_duration * self.video_rate
        return int(round(v) if abs(v - round(v)) < 1e-6 else v)

    @property
    def wind_size(self) -> int:
        w = int(self.fft_window * self.audio_rate)
        return int(2 ** np.round(np.log2(w)))

    @property
    def hop(self) -> int:
        return self.wind_size // N_OVERLAP

    @property
    def n_stft_frames(self) -> int:
        return N_OVERLAP * (self.snd_size // self.wind_size - 1)

    # --- encoder crop (model.py:166-172); py2 `/.` floats, int() truncation ---
    @property
    def enc_ss(self) -> int:
        ss = (self.snd_contx / 2.0) * (4.0 / self.wind_size)
        return int(ss - (INP_DIM - 1) / 2.0)

    @property
    def enc_tt(self) -> int:
        tt = (self.snd_contx / 2.0 + self.snd_dur) * (4.0 / self.wind_size)
        tt = int(tt + (INP_DIM - 1) / 2.0)
        return int(np.ceil((tt - self.enc_ss - INP_DIM) / 16.0) * 16 + INP_DIM + self.enc_ss)

    @property
    def n_enc_frames(self) -> int:
        return self.enc_tt - self.enc_ss

    # --- separation mask crops (model.py:313-324) ---
    @property
    def mask_ss(self) -> int:
        return int(np.floor((self.snd_contx / 2.0 - self.wind_size) * (4.0 / self.wind_size)))

    @property
    def mask_tt(self) -> int:
        return int(np.ceil((self.snd_contx / 2.0 + self.snd_dur + self.wind_size) * (4.0 / self.wind_size)))

    @property
    def n_mask_frames(self) -> int:
        return self.mask_tt - self.mask_ss

    @property
    def deconv_ss(self) -> int:
        """Start of the deconv-output crop: mask_ss - enc_ss (model.py:317-323;
        the reference re-derives the skip inline, but it is exactly enc_ss)."""
        return self.mask_ss - self.enc_ss

    @property
    def deconv_tt(self) -> int:
        return self.mask_tt - self.enc_ss

    # --- istft output crop (model.py:344-348) ---
    @property
    def out_ss(self) -> int:
        ss = self.snd_contx / 2.0
        skip = np.floor((self.snd_contx / 2.0 - self.wind_size) * (4.0 / self.wind_size)) * (self.wind_size / 4.0)
        skip += 3.0 * self.wind_size / 4.0  # the comb-stream ISTFT drops 3/4 window
        return int(ss - skip)

    @property
    def out_tt(self) -> int:
        return self.out_ss + self.snd_dur

    # --- narrowed deconv1 computation window ------------------------------
    # The mask path only keeps deconv1 output frames [deconv_ss, deconv_tt);
    # with a VALID transposed conv (kernel k, stride s) those depend only on
    # input frames [ceil((t0-(k-1))/s), floor((t1-1)/s)]. Computing deconv1
    # on that input slice is exact (every kept output frame sees all its
    # contributors) and skips ~3/4 of the reference's deconv1 work.
    @property
    def deconv1_in_lo(self) -> int:
        k, s = 7, 4  # AUDIO_KERNELS[0]/AUDIO_STRIDES[0] time dims
        return max(0, -(-(self.deconv_ss - (k - 1)) // s))

    @property
    def deconv1_in_hi(self) -> int:
        s = 4
        return (self.deconv_tt - 1) // s + 1

    @property
    def narrowed_deconv_ss(self) -> int:
        """deconv_ss in the narrowed deconv1 output's coordinates."""
        return self.deconv_ss - self.deconv1_in_lo * 4

    # --- no-separation crop (model.py:275-276, py2 int division) ---
    @property
    def nosep_ss(self) -> int:
        return self.snd_contx // 2

    # --- feeder window placement (feeder.py:66 semantics, fixed) ---
    def chunk_start_sample(self, t: float) -> int:
        """First input sample of the window centered at chunk time t.

        The window spans [t - context/2, t + context/2 + duration); sample
        placement rounds to nearest (NOT the reference's truncation, which
        drifts one sample early on times like 1.4 - 0.5 — see
        AudioChunkReader.get). Every consumer of window-start arithmetic
        (feeder, deploy span gather) must go through this."""
        return int(round((t - self.context / 2.0) * self.audio_rate))

    # --- training target slice (train.py:107-111, py2 int division) ---
    @property
    def target_ss(self) -> int:
        return int(self.audio_rate * self.context) // 2

    # --- eval metric windows (definitions.py:10-11, model.py:123-124) ---
    @property
    def metric_window(self) -> int:
        return int(0.025 * self.audio_rate)

    metric_overlap: int = dataclasses.field(default=2, init=False)

    def summary(self) -> str:
        keys = ["snd_contx", "snd_dur", "snd_size", "wind_size", "n_stft_frames",
                "enc_ss", "enc_tt", "mask_ss", "mask_tt", "deconv_ss", "deconv_tt",
                "out_ss", "out_tt", "nosep_ss", "target_ss"]
        return "\n".join(f"{k:16s} = {getattr(self, k)}" for k in keys)
