"""STFT/ISTFT as real matmuls against DFT basis matrices (port of
spatialaudiogen_tpu.ops.dft).

The bases are built in numpy exactly as the JAX package builds them
(float64 angles cast to float32), so both packages multiply by the same
bits. The matmuls are plain `torch.matmul`: in float32 with TF32 off
(`dft_precision="highest"`, see `precision_scope`) they are full float32
products.

  forward:  Re = (x*w) @ C,  Im = (x*w) @ S     with C/S = cos/sin(-2pi kn/N)
  inverse:  real(ifft(X))_n = (1/N) * (Re @ C + Im @ S)
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F

from spatialaudiogen_tpu_torch.dsp.stft import frame_count, hann_window, loss_frame_windows


@functools.lru_cache(maxsize=8)
def _basis(wind_size: int):
    k = np.arange(wind_size)
    ang = -2.0 * np.pi * np.outer(k, k) / wind_size
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


_DEVICE_CONSTS: dict = {}


@contextlib.contextmanager
def precision_scope(dft_precision: str):
    """TF32 off ("highest": every float32 matmul and cuDNN convolution a
    full float32 product) or allowed ("default") inside the block. torch's
    TF32 switches are process-wide, so the block restores the values it
    found on exit: a model's setting never outlives its forward (or its
    train step, whose backward runs inside the same block)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    tf32 = dft_precision != "highest"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def device_constant(key: tuple, make, device, dtype=torch.float32) -> torch.Tensor:
    """make()'s numpy array as a tensor on `device` in `dtype`, built and
    uploaded once per (key, device, dtype)."""
    key = key + (str(torch.device(device)), dtype)
    if key not in _DEVICE_CONSTS:
        _DEVICE_CONSTS[key] = torch.from_numpy(np.ascontiguousarray(make())).to(device, dtype)
    return _DEVICE_CONSTS[key]


def basis(wind_size: int, device, dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """(C, S) bases on `device`, uploaded once per device and dtype. They
    are the float32 values in any dtype (a float64 run multiplies by the
    same operator, exactly)."""
    c, s = _basis(wind_size)
    return (device_constant(("cos", wind_size), lambda: c, device, dtype),
            device_constant(("sin", wind_size), lambda: s, device, dtype))


@functools.lru_cache(maxsize=8)
def _half_basis(n: int):
    """Positive-angle bases over the non-redundant bins k = 0..n/2."""
    k = np.arange(n // 2 + 1)
    ang = 2.0 * np.pi * np.outer(k, np.arange(n)) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero: what cvt.rna.tf32.f32 does on the card."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


# The laid-out bases of the kernels' tensor-core routes
# (ops/csrc/istft_mma.cuh; K3 reads K1's): a step is 32 logical k, one wgmma's B tile is
# 256 columns x 32 bytes of k in 16-byte core matrices of 8 columns,
# core (nb, kc) at byte kc * 4096 + nb * 128, row i of the core at i * 16.
MMA_COLUMNS = 256
MMA_RESIDUES = MMA_COLUMNS // 4     # K1: hop residues per block
MMA_FREQS = MMA_COLUMNS // 2        # K2: output frequencies per block
MMA_ROUTES = {"default": (2, 8), "highest": (4, 4)}   # (wgmmas a step, values a 16-byte row)


def _mma_layout(wind_size: int, kernel: str, precision: str) -> np.ndarray:
    """float32 basis values in the byte order of K1's ("fwd") or K2's
    ("bwd") shared-memory B images, (tiles, steps, wgmmas, 2, 32, 8, E)
    for (column tile, step, wgmma w, k chunk kc, core nb, column i, value e).

    Slot (half, tig, j) of a step (istft_mma.cuh) is k chunk kc = half and
    tig, j = e // 2, 2 w + e % 2 (bf16 k16) or e, w (tf32 k8). Column
    c = 8 nb + i. K1: row 16 s + 4 tig + j of C (half 0) or S (half 1), at
    column q * hop + 64 tile + rr, c = 64 q + rr. K2: row
    32 s + 16 half + 4 tig + j of C (c < 128) or S at column
    128 tile + c % 128. Columns past the bases' edge (residues rr >= hop
    when F < 256, frequencies >= F when F < 128, and a last partial tile)
    are zero. F must be a multiple of 32."""
    if wind_size < 32 or wind_size % 32:
        raise ValueError(f"the kernels take F a multiple of 32, got {wind_size}")
    n_w, n_e = MMA_ROUTES[precision]
    hop = wind_size // 4
    c_b, s_b = _basis(wind_size)
    # one zero column past the edge, where out-of-range columns read
    bases = np.pad(np.stack([c_b, s_b]), ((0, 0), (0, 0), (0, 1)))
    if kernel == "fwd":
        tiles, steps = -(-hop // MMA_RESIDUES), wind_size // 16
    elif kernel == "bwd":
        tiles, steps = -(-wind_size // MMA_FREQS), wind_size // 32
    else:
        raise ValueError(f"kernel must be 'fwd' or 'bwd', got {kernel!r}")
    tile, s, w, kc, nb, i, e = np.ogrid[:tiles, :steps, :n_w, :2, :32, :8, :n_e]
    tig, j = (e // 2, 2 * w + e % 2) if n_e == 8 else (e, w)
    col = 8 * nb + i
    if kernel == "fwd":
        row = 16 * s + 4 * tig + j
        res = MMA_RESIDUES * tile + col % MMA_RESIDUES
        return bases[kc, row, np.where(res < hop, (col // MMA_RESIDUES) * hop + res, wind_size)]
    row = 32 * s + 16 * kc + 4 * tig + j
    freq = MMA_FREQS * tile + col % MMA_FREQS
    return bases[col // MMA_FREQS, row, np.where(freq < wind_size, freq, wind_size)]


def mma_basis(wind_size: int, device, kernel: str, precision: str
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) laid-out bases of K1 ("fwd") or K2 ("bwd") for `precision`,
    made once per (F, device, kernel, precision): bf16 twice (lo unused) for
    "default", the tf32 hi and lo parts of the float32 bases for
    "highest"."""
    key = ("mma", wind_size, str(torch.device(device)), kernel, precision)
    if key not in _DEVICE_CONSTS:
        x = torch.from_numpy(np.ascontiguousarray(_mma_layout(wind_size, kernel, precision)))
        if precision == "default":
            hi = lo = x.to(torch.bfloat16)
        else:
            hi = tf32_round(x)
            lo = tf32_round(x - hi)
        _DEVICE_CONSTS[key] = (hi.to(device), lo.to(device))
    return _DEVICE_CONSTS[key]


def _window(wind_size: int, device, dtype=torch.float32) -> torch.Tensor:
    return device_constant(("hann", wind_size),
                           lambda: np.asarray(hann_window(wind_size), np.float32),
                           device, dtype)


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


def frame_signal(x: torch.Tensor, wind_size: int, n_overlap: int) -> torch.Tensor:
    """(..., N) -> (..., n_frames, wind_size), frame t starting at t*hop,
    with n_frames = n_overlap * (N // wind_size - 1) (dsp.stft.frame_count;
    the JAX package's full framing). A strided view, no copy."""
    hop = wind_size // n_overlap
    n_frames = frame_count(x.shape[-1], wind_size, n_overlap)
    return x.unfold(-1, wind_size, hop)[..., :n_frames, :]


def stft_real(x: torch.Tensor, wind_size: int, n_overlap: int,
              frame_start: int | None = None, n_frames: int | None = None):
    """Real-arithmetic STFT: (..., N) -> (Re, Im), each (..., n_frames, wind).

    With frame_start/n_frames only that frame range is framed and
    transformed; without them, the full framing (frame_signal)."""
    if (n_frames is None) != (frame_start is None):
        raise ValueError("frame_start and n_frames go together")
    if frame_start is not None:
        frames = frame_signal_range(x, wind_size, n_overlap, frame_start, n_frames)
    else:
        frames = frame_signal(x, wind_size, n_overlap)
    frames = frames * _window(wind_size, x.device, x.dtype)
    c, s = basis(wind_size, x.device, x.dtype)
    return torch.matmul(frames, c), torch.matmul(frames, s)


def stft_for_loss_real(signal: torch.Tensor, window: int, n_overlap: int):
    """Loss-side STFT (counterpart of the JAX ops.dft.stft_for_loss_real):
    (B, N, C) -> (Re, Im) each (B, C, n_frames, window_pow2), with the
    pow2 rounding and framing of dsp.stft.loss_frame_windows."""
    windows, window = loss_frame_windows(signal, window, n_overlap)
    windows = windows * _window(window, signal.device, signal.dtype)
    c, s = basis(window, signal.device, signal.dtype)
    return torch.matmul(windows, c), torch.matmul(windows, s)


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
