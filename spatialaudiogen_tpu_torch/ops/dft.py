"""STFT/ISTFT as real matmuls against DFT basis matrices (port of
spatialaudiogen_tpu.ops.dft).

The bases are built in numpy exactly as the JAX package builds them
(float64 angles cast to float32), so both packages multiply by the same
bits. The matmuls are plain `torch.matmul`: in float32 with TF32 off
(`dft_precision="highest"`, see models.sptaudiogen.set_precision) they are
full float32 products.

  forward:  Re = (x*w) @ C,  Im = (x*w) @ S     with C/S = cos/sin(-2pi kn/N)
  inverse:  real(ifft(X))_n = (1/N) * (Re @ C + Im @ S)
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from spatialaudiogen_tpu.dsp.stft import hann_window


@functools.lru_cache(maxsize=8)
def _basis(wind_size: int):
    k = np.arange(wind_size)
    ang = -2.0 * np.pi * np.outer(k, k) / wind_size
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


_DEVICE_CONSTS: dict = {}


def basis(wind_size: int, device, dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """(C, S) bases on `device`, uploaded once per device and dtype. They
    are the float32 values in any dtype (a float64 run multiplies by the
    same operator, exactly)."""
    key = ("basis", wind_size, str(torch.device(device)), dtype)
    if key not in _DEVICE_CONSTS:
        c, s = _basis(wind_size)
        _DEVICE_CONSTS[key] = (torch.from_numpy(c).to(device, dtype),
                               torch.from_numpy(s).to(device, dtype))
    return _DEVICE_CONSTS[key]


def _window(wind_size: int, device, dtype=torch.float32) -> torch.Tensor:
    key = ("hann", wind_size, str(torch.device(device)), dtype)
    if key not in _DEVICE_CONSTS:
        win = np.asarray(hann_window(wind_size), np.float32)
        _DEVICE_CONSTS[key] = torch.from_numpy(win).to(device, dtype)
    return _DEVICE_CONSTS[key]


def frame_signal_range(x: torch.Tensor, wind_size: int, n_overlap: int,
                       t0: int, n_frames: int) -> torch.Tensor:
    """Frames [t0, t0+n_frames) of the hop=wind/n_overlap framing of x
    (..., N) -> (..., n_frames, wind), zero-padded past the end exactly as
    the JAX version pads (to a whole number of comb windows)."""
    hop = wind_size // n_overlap
    n_pad = -(-n_frames // n_overlap) * n_overlap
    need = (t0 + n_pad - 1) * hop + wind_size
    if need > x.shape[-1]:
        x = F.pad(x, (0, need - x.shape[-1]))
    # frame t starts at sample t*hop: a strided view, no copy
    return x.unfold(-1, wind_size, hop)[..., t0: t0 + n_frames, :]


def stft_real(x: torch.Tensor, wind_size: int, n_overlap: int,
              frame_start: int, n_frames: int):
    """Real-arithmetic STFT over a frame range: (..., N) -> (Re, Im), each
    (..., n_frames, wind)."""
    frames = frame_signal_range(x, wind_size, n_overlap, frame_start, n_frames)
    frames = frames * _window(wind_size, x.device, x.dtype)
    c, s = basis(wind_size, x.device, x.dtype)
    return torch.matmul(frames, c), torch.matmul(frames, s)


def istft_real(re: torch.Tensor, im: torch.Tensor, n_overlap: int) -> torch.Tensor:
    """Inverse of stft_real under the comb-stream overlap-add:
    (..., n_frames, n_freqs) real pairs -> (..., out_len) real."""
    n_freqs = re.shape[-1]
    c, s = basis(n_freqs, re.device, re.dtype)
    x = (torch.matmul(re, c) + torch.matmul(im, s)) / float(n_freqs)
    return _overlap_add(x, n_overlap)


def _overlap_add(x: torch.Tensor, n_overlap: int) -> torch.Tensor:
    """Comb-stream overlap-add of per-frame ifft outputs (..., T, F) -> (..., L).

    Stream k (frames t % n_overlap == k) is butt-joined and starts at
    (n_overlap-1-k)*hop; trailing frames beyond a multiple of n_overlap are
    dropped."""
    *batch, n_frames, n_freqs = x.shape
    hop = n_freqs // n_overlap
    n_winds = n_frames // n_overlap
    x = x[..., : n_winds * n_overlap, :].reshape(*batch, n_winds, n_overlap, n_freqs)
    x = x.transpose(-2, -3).reshape(*batch, n_overlap, n_winds * n_freqs)
    out_len = n_winds * n_freqs - (n_overlap - 1) * hop
    acc = 0.0
    for k in range(n_overlap):
        start = (n_overlap - 1 - k) * hop
        acc = acc + x[..., k, start: start + out_len]
    return acc / float(n_overlap)
