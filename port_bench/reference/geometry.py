"""Window and crop indices of the SptAudioGen model (Morgado et al., 2018,
github.com/pedro-morgado/spatialaudiogen, model.py:161-172, 313-348),
written out for the reference. Every value is a plain int."""

from __future__ import annotations

import dataclasses
import math

ENC_RECEPTIVE = 95      # encoder receptive field in STFT frames (model.py:166)
N_OVERLAP = 4           # STFT overlap factor of the model (model.py:369)


@dataclasses.dataclass(frozen=True)
class Geometry:
    audio_rate: int = 48000
    video_rate: int = 10
    context: float = 1.0
    duration: float = 0.1
    fft_window: float = 0.025

    @property
    def contx(self) -> int:
        return int(self.context * self.audio_rate)

    @property
    def snd_dur(self) -> int:
        return int(self.duration * self.audio_rate)

    @property
    def snd_size(self) -> int:
        return self.contx + self.snd_dur - 1

    @property
    def vid_dur(self) -> int:
        return int(round(self.duration * self.video_rate))

    @property
    def wind(self) -> int:
        return int(2 ** round(math.log2(int(self.fft_window * self.audio_rate))))

    @property
    def hop(self) -> int:
        return self.wind // N_OVERLAP

    @property
    def enc_ss(self) -> int:
        return int(self.contx / 2.0 * 4.0 / self.wind - (ENC_RECEPTIVE - 1) / 2.0)

    @property
    def n_enc(self) -> int:
        tt = int((self.contx / 2.0 + self.snd_dur) * 4.0 / self.wind + (ENC_RECEPTIVE - 1) / 2.0)
        tt = math.ceil((tt - self.enc_ss - ENC_RECEPTIVE) / 16.0) * 16 + ENC_RECEPTIVE + self.enc_ss
        return tt - self.enc_ss

    @property
    def mask_ss(self) -> int:
        return math.floor((self.contx / 2.0 - self.wind) * 4.0 / self.wind)

    @property
    def n_mask(self) -> int:
        tt = math.ceil((self.contx / 2.0 + self.snd_dur + self.wind) * 4.0 / self.wind)
        return tt - self.mask_ss

    @property
    def out_ss(self) -> int:
        skip = math.floor((self.contx / 2.0 - self.wind) * 4.0 / self.wind) * self.wind / 4.0
        return int(self.contx / 2.0 - skip - 3.0 * self.wind / 4.0)

    @property
    def target_ss(self) -> int:
        return self.contx // 2

    def chunk_start(self, t: float) -> int:
        """First input sample of the window of chunk time t."""
        return int(round((t - self.context / 2.0) * self.audio_rate))
