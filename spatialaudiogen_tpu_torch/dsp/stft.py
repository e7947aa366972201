"""STFT / ISTFT with the reference model's exact framing semantics, on
torch tensors (port of spatialaudiogen_tpu.dsp.stft).

The reference's TF1 `stft` (myutils.py:119-147) is a plain hop =
wind/n_overlap STFT whose frame count is truncated to
n_overlap * (floor(N/wind) - 1) frames (frame t covers samples
[t*hop, t*hop + wind)), followed by a full complex FFT over all wind bins.

`istft` (myutils.py:181-211): ifft each frame, split the frames into
n_overlap comb streams (t % n_overlap == k), butt-join each stream, trim
so all streams align on sample window*(n_overlap-1)/n_overlap onward, and
average the streams (divide by n_overlap, not by the window overlap sum:
a unit mask reproduces the input scaled by sum(hann)/n_overlap = 0.5 for
n_overlap=4; checkpoint weights bake this in).

`stft_for_loss` (myutils.py:151-178) is the loss-side variant over the
framing of `loss_frame_windows`: window rounded UP to the next power of
two, overlap streams concatenated frame-major per stream (ordering
irrelevant to the mean-reduced loss but kept identical).

These are the FFT reference functions (torch.fft); the model runs the
real-matmul DFTs of ops.dft.
"""

from __future__ import annotations

import numpy as np
import torch


def hann_window(wind_size: int) -> np.ndarray:
    """Periodic Hann window, matching myutils.py:134."""
    return 0.5 - 0.5 * np.cos(2 * np.pi / wind_size * np.arange(wind_size))


def frame_count(n_samples: int, wind_size: int, n_overlap: int) -> int:
    return n_overlap * (n_samples // wind_size - 1)


def loss_frame_windows(signal: torch.Tensor, window: int, n_overlap: int):
    """Shared loss-side framing: (B, N, C) -> ((B, C, nW, window_pow2)
    windows, window_pow2).

    Window is rounded UP to the next power of two (myutils.py:155); the
    overlap streams are concatenated stream-major, each stream's frame
    count using the reference's py2-faithful `(n - i*stride - 1) / window`
    truncation.
    """
    bs, n, nc = signal.shape
    window = int(2 ** np.ceil(np.log(window) / np.log(2)))

    if n_overlap == 1:
        n_w = int(float(n) / window)
        if n_w > 1:
            sig = signal[:, : window * n_w, :] if n > window * n_w else signal
            windows = sig.reshape(bs, n_w, window, nc)
        else:
            windows = signal[:, None]
    else:
        stride = int(window / n_overlap)
        parts = []
        for i in range(n_overlap):
            n_w = int(float(n - i * stride - 1) / window)
            y = signal[:, i * stride: i * stride + window * n_w, :]
            parts.append(y.reshape(bs, n_w, window, nc))
        windows = torch.cat(parts, dim=1)

    return windows.permute(0, 3, 1, 2), window                # (B, C, nW, window)


def frame_signal(x: torch.Tensor, wind_size: int, n_overlap: int) -> torch.Tensor:
    """(..., N) -> (..., n_frames, wind_size), frame t starting at t*hop,
    with n_frames = frame_count(N, ...). A strided view, no copy."""
    hop = wind_size // n_overlap
    n_frames = frame_count(x.shape[-1], wind_size, n_overlap)
    return x.unfold(-1, wind_size, hop)[..., :n_frames, :]


def _hann(wind_size: int, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(hann_window(wind_size)).to(like.device, like.dtype)


def stft(x: torch.Tensor, wind_size: int, n_overlap: int) -> torch.Tensor:
    """Complex STFT: (..., N) -> (..., n_frames, wind_size), complex.

    Full complex FFT over all wind_size bins (not rfft): the learned
    separation mask covers all bins (reference myutils.py:138)."""
    frames = frame_signal(x, wind_size, n_overlap)
    return torch.fft.fft(frames * _hann(wind_size, frames), dim=-1)


def istft(spec: torch.Tensor, n_overlap: int) -> torch.Tensor:
    """Inverse of `stft` under the reference's comb-stream overlap-add.

    (..., n_frames, n_freqs) complex -> (..., out_len) real where
    out_len = (n_frames // n_overlap) * n_freqs - (n_overlap - 1) * hop.
    Output sample s corresponds to signal sample s + (n_overlap-1)*hop of
    the original framing."""
    *batch, n_frames, n_freqs = spec.shape
    hop = n_freqs // n_overlap
    n_winds = n_frames // n_overlap
    x = torch.fft.ifft(spec[..., : n_winds * n_overlap, :], dim=-1).real
    # stream k = frames with t % n_overlap == k, butt-joined
    x = x.reshape(*batch, n_winds, n_overlap, n_freqs).transpose(-2, -3)
    streams = x.reshape(*batch, n_overlap, n_winds * n_freqs)
    out_len = n_winds * n_freqs - (n_overlap - 1) * hop
    acc = 0.0
    for k in range(n_overlap):
        start = (n_overlap - 1 - k) * hop
        acc = acc + streams[..., k, start: start + out_len]
    return acc / float(n_overlap)


def stft_for_loss(signal: torch.Tensor, window: int, n_overlap: int) -> torch.Tensor:
    """Loss-side STFT: (B, N, C) -> (B, C, n_frames, window_pow2) complex
    (myutils.py:151-178 semantics)."""
    windows, window = loss_frame_windows(signal, window, n_overlap)
    return torch.fft.fft(windows * _hann(window, signal), dim=-1)
