"""Device twins of the host eval metrics: mel-LSD and Hilbert-envelope
distance as matmuls (port of spatialaudiogen_tpu.ops.eval_metrics).

With these (+ ops/sinkhorn.py for EMD) the entire reference eval battery
(eval.py:125-132) runs on the card: `cli.eval --device_metrics --emd
sinkhorn` leaves the host nothing but feeding and file writes. Semantics
mirror eval/host_metrics.py (itself pinned to the reference's librosa/scipy
calls, myutils.py:96-116):

  * mel-LSD: centered power spectrogram (n_fft 2048, hop 512, periodic
    hann, reflect pad) as a framed real-DFT matmul, Slaney mel filterbank,
    10*log10(. + 1e-2), RMS of the dB difference.
  * envelope distance: the Hilbert transform of a length-T real signal is
    a circulant linear operator (kernel Im(ifft(u)), u the analytic-signal
    spectral mask), so |hilbert(x)| = sqrt(x^2 + (H @ x)^2) costs one
    (T, T) matmul: 4800x4800 float32 is 92 MB of basis, built once per T on
    the host and uploaded once per device.

The JAX functions run their matmuls at HIGHEST precision. Here each metric
runs inside precision_scope("highest"): TF32 off whatever switches the
caller (a dft_precision="default" model's forward, say) left set, and
those switches restored on return. The bases take the inputs' dtype, so a
float64 run computes the same operator.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from spatialaudiogen_tpu_torch.dsp.stft import hann_window
from spatialaudiogen_tpu_torch.eval.host_metrics import mel_filterbank
from spatialaudiogen_tpu_torch.ops.dft import _half_basis, device_constant, precision_scope

N_FFT = 2048
HOP = 512
N_MELS = 128
FMAX = 12000.0
EPS = 1e-2  # myutils.py:103 log floor


@functools.lru_cache(maxsize=4)
def _dft_mats(n_fft: int = N_FFT):
    """Real-DFT bases (n_fft, n_fft//2+1) from the shared matmul-DFT path
    (ops/dft.py), with the periodic hann folded in (power spectra are
    sign-of-angle invariant, so the half bases serve directly)."""
    cos_kn, sin_kn = _half_basis(n_fft)
    win = hann_window(n_fft).astype(np.float32)
    return ((cos_kn.T * win[:, None]).astype(np.float32),
            (sin_kn.T * win[:, None]).astype(np.float32))


@functools.lru_cache(maxsize=4)
def _hilbert_kernel(t: int) -> np.ndarray:
    """(T, T) circulant Hilbert-transform matrix (scipy.signal.hilbert's
    Im part: analytic = ifft(fft(x) * u), u = [1, 2...2, 1, 0...0])."""
    u = np.zeros(t)
    u[0] = 1.0
    if t % 2 == 0:
        u[1: t // 2] = 2.0
        u[t // 2] = 1.0
    else:
        u[1: (t + 1) // 2] = 2.0
    k = np.fft.ifft(u).imag  # response to a delta at n=0
    idx = (np.arange(t)[:, None] - np.arange(t)[None, :]) % t
    return k[idx].astype(np.float32)


def mel_lsd_batch_fn(rate: int, n_mels: int = N_MELS, fmax: float = FMAX):
    """(pred, gt) -> (B, C) per-channel mel-LSD.

    pred/gt: (B, T, C) tensors. Matches eval/host_metrics.compute_mel_lsd
    (reference myutils.py:96-106) to ~1e-3 dB: reflect-centered frames,
    framed real-DFT power via two full-float32 matmuls, Slaney mel
    filterbank, RMS over (mel, frame) of the dB difference.
    """
    pad = N_FFT // 2

    def mel_db(x):
        # x: (B, T, C) -> (B, C, F, n_mels) in dB
        cos_m = device_constant(("mel_cos", N_FFT), lambda: _dft_mats(N_FFT)[0],
                                x.device, x.dtype)
        sin_m = device_constant(("mel_sin", N_FFT), lambda: _dft_mats(N_FFT)[1],
                                x.device, x.dtype)
        fb = device_constant(
            ("mel_fb", rate, n_mels, fmax),
            lambda: mel_filterbank(rate, N_FFT, n_mels, 0.0, fmax).astype(np.float32),
            x.device, x.dtype)
        # the host twin pads constant when the signal is shorter than the
        # pad (host_metrics._stft_power; reflect would raise there and here)
        mode = "reflect" if x.shape[1] > pad else "constant"
        xp = F.pad(x.transpose(1, 2), (pad, pad), mode=mode)   # (B, C, T + 2 pad)
        frames = xp.unfold(-1, N_FFT, HOP)                       # (B, C, F, W)
        re, im = frames @ cos_m, frames @ sin_m
        mel = (re * re + im * im) @ fb.T
        return 10.0 * torch.log10(mel + EPS)

    def metric(pred, gt):
        with precision_scope("highest"):
            diff = mel_db(pred) - mel_db(gt)
            return torch.sqrt(torch.mean(diff * diff, dim=(2, 3)))  # (B, C)

    return metric


def envelope_dist_fn(t: int):
    """(pred, gt) -> (B, C) Hilbert-envelope RMS distance.

    Matches eval/host_metrics.compute_envelope_dist (myutils.py:109-116):
    envelope = sqrt(x^2 + (Hx)^2) with H the circulant Hilbert matrix.
    """

    def metric(pred, gt):
        with precision_scope("highest"):
            h = device_constant(("hilbert", t), lambda: _hilbert_kernel(t),
                                pred.device, pred.dtype)

            def env(x):
                hx = h @ x
                return torch.sqrt(x * x + hx * hx)

            d = env(pred) - env(gt)
            return torch.sqrt(torch.mean(d * d, dim=1))  # (B, C)

    return metric
