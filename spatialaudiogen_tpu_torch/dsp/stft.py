"""STFT framing helpers with the reference model's exact semantics (the
port's copy of the parts of spatialaudiogen_tpu.dsp.stft it calls; the
framing works on torch tensors).

`loss_frame_windows` (myutils.py:151-178) is the loss-side framing: window
rounded UP to the next power of two, overlap streams concatenated
frame-major per stream (ordering irrelevant to the mean-reduced loss but
kept identical).
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
