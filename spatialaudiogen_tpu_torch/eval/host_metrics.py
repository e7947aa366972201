"""Host-side (numpy) per-sample eval metrics.

Replaces the reference's librosa/scipy dependencies (myutils.py:96-116):
  * mel-LSD: log-mel spectrogram distance. The mel spectrogram follows
    librosa.feature.melspectrogram semantics (n_fft=2048, hop=512, centered
    hann, power 2, Slaney mel scale + Slaney filter normalization,
    n_mels=128, fmax=12000) implemented directly with numpy.
  * envelope distance: RMS distance between Hilbert envelopes.
Both operate on (T, C) float arrays and return per-channel distances (C,).
"""

from __future__ import annotations

import functools

import numpy as np

# --- Slaney mel scale (librosa htk=False) ---
_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    mel = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    mel = np.where(log_region, _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP, mel)
    return mel


def mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    return np.where(log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), f)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sr: int, n_fft: int = 2048, n_mels: int = 128,
                   fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) triangular Slaney-normalized filterbank."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    # Slaney normalization: equal area per filter
    enorm = 2.0 / (mel_pts[2: n_mels + 2] - mel_pts[:n_mels])
    return weights * enorm[:, None]


def _stft_power(y: np.ndarray, n_fft: int = 2048, hop: int = 512) -> np.ndarray:
    """Centered power spectrogram |STFT|^2, (1 + n_fft//2, n_frames)."""
    pad = n_fft // 2
    y = np.pad(y, pad, mode="reflect" if y.shape[0] > pad else "constant")
    n_frames = 1 + (y.shape[0] - n_fft) // hop
    # periodic hann (librosa / scipy sym=False)
    win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = y[idx] * win
    spec = np.fft.rfft(frames, axis=1)
    return (spec.real ** 2 + spec.imag ** 2).T


def melspectrogram(y: np.ndarray, sr: int, n_mels: int = 128,
                   fmax: float | None = None, n_fft: int = 2048,
                   hop: int = 512) -> np.ndarray:
    """(n_mels, n_frames) mel power spectrogram of a 1-D signal."""
    power = _stft_power(np.asarray(y, dtype=np.float64), n_fft, hop)
    return mel_filterbank(sr, n_fft, n_mels, 0.0, fmax) @ power


def compute_mel_lsd(pred: np.ndarray, gt: np.ndarray, rate: int) -> np.ndarray:
    """Per-channel mel log-spectral distance (myutils.py:96-106 semantics)."""
    eps = 1e-2
    dist = np.zeros(gt.shape[1])
    for i in range(gt.shape[1]):
        sp = 10 * np.log10(melspectrogram(pred[:, i], rate, 128, 12000) + 0.0 + eps)
        sg = 10 * np.log10(melspectrogram(gt[:, i], rate, 128, 12000) + 0.0 + eps)
        dist[i] = np.sqrt(np.mean((sg - sp) ** 2))
    return dist


def compute_envelope_dist(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Per-channel Hilbert-envelope RMS distance (myutils.py:109-116)."""
    from scipy.signal import hilbert

    dist = np.zeros(gt.shape[1])
    for i in range(gt.shape[1]):
        pe = np.abs(hilbert(pred[:, i]))
        ge = np.abs(hilbert(gt[:, i]))
        dist[i] = np.sqrt(np.mean((ge - pe) ** 2))
    return dist
