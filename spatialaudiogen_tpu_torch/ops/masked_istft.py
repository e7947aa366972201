"""Fused masked comb-ISTFT (K1), its fused backward (K2) and K1 over an
NHWC mask (K3): the CUDA kernels' wrappers, their plain PyTorch versions,
the autograd functions that join them, and the kernels' build.

`masked_istft` is the counterpart of
spatialaudiogen_tpu.ops.pallas_kernels.masked_istft_pallas (same inputs and
output; `interpret` has no counterpart), differentiable in all three
inputs. For CUDA tensors the forward launches K1 (csrc/masked_istft.cu)
and the backward K2 (csrc/masked_istft_bwd.cu); for CPU tensors it runs
`masked_istft_plain`, the counterpart of `masked_istft_reference`, and
autograd differentiates that. `masked_istft_bwd` is K2's wrapper and
`masked_istft_bwd_plain` its plain version, the counterpart of
`_bwd_xla`. `masked_istft_nhwc` is the counterpart of
masked_istft_nhwc_pallas: mono spectra and a (B, T, F, tracks) mask, read
in place as a strided view; CUDA tensors launch K3
(csrc/masked_istft_nhwc.cu) and differentiate through K2 on the mask made
track-major, as _nhwc_bwd does; CPU tensors run `masked_istft_nhwc_plain`.
There is no fallback between the routes: a CUDA input a kernel cannot take
raises. The kernels take any frame count and any F that is a multiple of
32 (the model's F is a power of two, 1024 and up where the model builds).

`precision` (the model's pallas_precision) picks K1's, K2's and K3's
route on the tensor cores (csrc/istft_mma.cuh), and the backward gets the
forward's: "default" rounds both GEMM operands to bf16 and accumulates in
f32 (one wgmma pass, the TPU's DEFAULT, about 2e-3 relative L2 from f32);
"highest" runs 3xTF32 (f32-grade). The plain versions take the same
argument: "default" rounds the same two operands to bf16 and multiplies in
f32, which is what the card's checks hold the bf16 route to. The CPU
route runs the f32 plain version whatever `precision` says, as the JAX
model's non-Pallas branch uses dft_precision. On an H100 (NVIDIA's peaks)
the work of one flagship call at batch 16, 60.1 GFLOP against about 80 MB,
is bound by operations: 0.061 ms in bf16, 0.364 ms in 3xTF32.

The kernels are compiled with nvcc at first use into `build/` beside this
file (`.gitignore` lists it), one nvcc per source, all started together,
then linked into one library, rebuilt when any source's or header's hash
changes. They are plain C entry points loaded with ctypes, so the build
needs no PyTorch headers and takes seconds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from spatialaudiogen_tpu_torch.ops.dft import _overlap_add, basis, mma_basis

CSRC = Path(__file__).parent / "csrc"
SOURCES = (CSRC / "masked_istft.cu", CSRC / "masked_istft_bwd.cu",
           CSRC / "masked_istft_nhwc.cu")
HEADERS = (CSRC / "istft_mma.cuh",)   # included by the sources; in the hash
BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
PRECISIONS = {"default": 0, "highest": 1}   # routes: bf16, 3xTF32
NHWC_VEC_TRACKS = 4    # K3's vector route: one load brings 4 tracks of a (t, f)

# Launches of K1, K2 and K3 (never of the plain versions); read and reset
# by callers that need to show the main path went through the kernels.
launch_count = 0
bwd_launch_count = 0
nhwc_launch_count = 0


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be 'highest' or 'default', got {precision!r}")


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even), kept in its dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def _bases(f: int, device, dtype, precision: str):
    c, s = basis(f, device, dtype)
    return (_bf16(c), _bf16(s)) if precision == "default" else (c, s)


def masked_istft_plain(re: torch.Tensor, im: torch.Tensor, mask: torch.Tensor,
                       n_overlap: int = 4, precision: str = "highest") -> torch.Tensor:
    """Plain PyTorch version: istft_real of the masked spectra, in the
    dtype of re/im (float32 on the model's path). With precision="default"
    the GEMM operands (re*m, im*m and the bases) are rounded to bf16 and
    multiplied in that dtype, as K1's bf16 route does.

    re, im: (B, n_in, T, F); mask: (B, n_in, TR, T, F) -> (B, n_in, TR, out_len)."""
    _check_precision(precision)
    mask = mask.to(re.dtype)
    rm, imm = re[:, :, None] * mask, im[:, :, None] * mask
    if precision == "default":
        rm, imm = _bf16(rm), _bf16(imm)
    f = re.shape[-1]
    c, s = _bases(f, re.device, re.dtype, precision)
    return _overlap_add((torch.matmul(rm, c) + torch.matmul(imm, s)) / float(f), n_overlap)


def masked_istft(re: torch.Tensor, im: torch.Tensor, mask: torch.Tensor,
                 n_overlap: int = 4, precision: str = "highest") -> torch.Tensor:
    """Fused masked comb-ISTFT.

    re, im: (B, n_in, T, F) float32 spectra; mask: (B, n_in, TR, T, F)
    float32 or bfloat16. Returns (B, n_in, TR, out_len) float32 track
    waveforms, out_len = (T//4)*F - 3*F/4. Trailing frames beyond a multiple
    of n_overlap are dropped, as istft_real does, and get zero gradient.
    On the card `precision` picks K1's and K2's route: "default" bf16,
    "highest" 3xTF32; on the CPU the plain version runs in float32 for both.
    """
    _check_precision(precision)
    if _route(re, im, mask) == "cpu":
        return masked_istft_plain(re, im, mask, n_overlap)
    return _MaskedISTFT.apply(re, im, mask, n_overlap, precision)


def masked_istft_bwd_plain(re: torch.Tensor, im: torch.Tensor, mask: torch.Tensor,
                           g: torch.Tensor, n_overlap: int = 4, precision: str = "highest"):
    """Plain PyTorch version of K2, the counterpart of _bwd_xla: the
    gradients (d_re, d_im, d_mask) of masked_istft at output cotangent g
    (B, n_in, TR, out_len). d_re/d_im are float32, d_mask is in the mask's
    dtype; trailing frames beyond a multiple of n_overlap get zeros. With
    precision="default" the GEMM operands (the scaled scattered cotangent
    and the bases) are rounded to bf16, as K2's bf16 route does."""
    _check_precision(precision)
    b, n_in, t, f = re.shape
    hop = f // n_overlap
    t_use = (t // n_overlap) * n_overlap
    front = (n_overlap - 1) * hop
    # scatter g back onto the comb streams: frame t, column n of a track
    # is output sample (t - n_overlap + 1)*hop + n, zero outside [0, out_len)
    gp = F.pad(g / float(n_overlap), (front, t_use * hop - g.shape[-1]))
    gx = gp.unfold(-1, f, hop)[..., :t_use, :] / float(f)   # (B, n_in, TR, t_use, F)
    if precision == "default":
        gx = _bf16(gx)
    c, s = _bases(f, re.device, re.dtype, precision)
    g_rm = torch.matmul(gx, c)                     # C, S symmetric: C^T = C
    g_im = torch.matmul(gx, s)
    re_u, im_u, m_u = re[:, :, None, :t_use], im[:, :, None, :t_use], mask[..., :t_use, :]
    d_mask = (g_rm * re_u + g_im * im_u).to(mask.dtype)
    d_re = (g_rm * m_u).sum(2)
    d_im = (g_im * m_u).sum(2)
    if t_use != t:
        d_re, d_im = (F.pad(x, (0, 0, 0, t - t_use)) for x in (d_re, d_im))
        d_mask = F.pad(d_mask, (0, 0, 0, t - t_use))
    return d_re, d_im, d_mask


def masked_istft_bwd(re: torch.Tensor, im: torch.Tensor, mask: torch.Tensor,
                     g: torch.Tensor, n_overlap: int = 4, precision: str = "highest"):
    """K2's wrapper: the gradients (d_re, d_im, d_mask) of masked_istft at
    output cotangent g. CUDA tensors launch K2 on the route `precision`
    picks; CPU tensors run masked_istft_bwd_plain in float32."""
    _check_precision(precision)
    if _route(re, im, mask, g) == "cpu":
        return masked_istft_bwd_plain(re, im, mask, g, n_overlap)
    return _launch_bwd(re, im, mask, g, n_overlap, precision)


def masked_istft_nhwc_plain(re: torch.Tensor, im: torch.Tensor, mask: torch.Tensor,
                            n_overlap: int = 4, precision: str = "highest") -> torch.Tensor:
    """Plain PyTorch version of K3: the mask viewed track-major, then
    masked_istft_plain at `precision` ("default" rounds the same operands
    to bf16 as K3's bf16 route does).

    re, im: (B, T, F); mask: (B, T, F, TR) -> (B, TR, out_len)."""
    return masked_istft_plain(re[:, None], im[:, None], mask.permute(0, 3, 1, 2)[:, None],
                              n_overlap, precision)[:, 0]


def masked_istft_nhwc(re: torch.Tensor, im: torch.Tensor, mask: torch.Tensor,
                      n_overlap: int = 4, precision: str = "highest") -> torch.Tensor:
    """Fused masked comb-ISTFT over an NHWC (deconv-native) mask, mono input.

    re, im: (B, T, F) float32 spectra of the input channel; mask:
    (B, T, F, TR) float32 or bfloat16, any strides (the U-Net's cropped
    channels_last output is read in place). Returns (B, TR, out_len)
    float32, what masked_istft returns on the mask made track-major;
    trailing frames beyond a multiple of n_overlap are dropped and get zero
    gradient. On the card `precision` picks the route of K3 and of its
    backward, K2: "default" bf16, "highest" 3xTF32; on the CPU the plain
    version runs in float32 for both."""
    _check_precision(precision)
    if _route(re, im, mask) == "cpu":
        return masked_istft_nhwc_plain(re, im, mask, n_overlap)
    return _MaskedISTFTNHWC.apply(re, im, mask, n_overlap, precision)


class _MaskedISTFT(torch.autograd.Function):
    """K1 forward, K2 backward at the same precision (the custom VJP of
    masked_istft_pallas, whose precision is a nondiff argument)."""

    @staticmethod
    def forward(ctx, re, im, mask, n_overlap, precision):
        ctx.save_for_backward(re, im, mask)
        ctx.n_overlap, ctx.precision = n_overlap, precision
        return _launch(re, im, mask, n_overlap, precision)

    @staticmethod
    def backward(ctx, g):
        re, im, mask = ctx.saved_tensors
        d_re, d_im, d_mask = _launch_bwd(re, im, mask, g.contiguous(), ctx.n_overlap,
                                         ctx.precision)
        return d_re, d_im, d_mask, None, None


class _MaskedISTFTNHWC(torch.autograd.Function):
    """K3 forward; backward as _nhwc_bwd: K2 on the mask made track-major
    and contiguous, d_mask handed back as an NHWC view in the mask dtype."""

    @staticmethod
    def forward(ctx, re, im, mask, n_overlap, precision):
        ctx.save_for_backward(re, im, mask)
        ctx.n_overlap, ctx.precision = n_overlap, precision
        return _launch_nhwc(re, im, mask, n_overlap, precision)

    @staticmethod
    def backward(ctx, g):
        re, im, mask = ctx.saved_tensors
        mask_tm = mask.permute(0, 3, 1, 2)[:, None].contiguous()
        d_re, d_im, d_mask = _launch_bwd(re[:, None], im[:, None], mask_tm,
                                         g[:, None].contiguous(), ctx.n_overlap, ctx.precision)
        return d_re[:, 0], d_im[:, 0], d_mask[:, 0].permute(0, 2, 3, 1), None, None


def _route(*tensors) -> str:
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"masked_istft runs on CPU or CUDA tensors, got {device}")
    return device.type


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"masked_istft kernel: {msg}")


def _bn_stride(x: torch.Tensor) -> int:
    """Element stride of the flattened (B * n_in) axis, which the kernel
    walks with one stride."""
    b, n_in = x.shape[:2]
    _check(n_in == 1 or b == 1 or x.stride(0) == n_in * x.stride(1),
           f"(B, n_in) axes of shape {tuple(x.shape)} and strides "
           f"{x.stride()} do not flatten to one stride")
    return x.stride(1) if n_in > 1 else x.stride(0)


def _check_freqs(f: int):
    # a K2 step is 32 samples of a frame, a K1/K3 step 16 frequencies, and
    # the comb scatter loads g as float4 (hop = F/4 a multiple of 8)
    _check(f >= 32 and f % 32 == 0, f"F must be a multiple of 32, got {f}")


def _check_inputs(re, im, mask, n_overlap):
    """Checks what both kernels take; returns (b, n_in, tracks, t, t_use, f)."""
    _check(n_overlap == 4, f"n_overlap must be 4, got {n_overlap}")
    _check(re.dtype == im.dtype == torch.float32, f"re/im must be float32, got "
           f"{re.dtype}/{im.dtype}")
    _check(mask.dtype in (torch.float32, torch.bfloat16),
           f"mask must be float32 or bfloat16, got {mask.dtype}")
    _check(re.dim() == 4 and im.shape == re.shape, f"re/im must be (B, n_in, T, F) "
           f"of one shape, got {tuple(re.shape)}/{tuple(im.shape)}")
    b, n_in, t, f = re.shape
    _check(mask.dim() == 5 and mask.shape[:2] == (b, n_in) and mask.shape[3:] == (t, f),
           f"mask must be (B, n_in, TR, T, F) = ({b}, {n_in}, TR, {t}, {f}), "
           f"got {tuple(mask.shape)}")
    t_use = (t // n_overlap) * n_overlap
    _check(t_use >= n_overlap, f"needs at least {n_overlap} frames, got {t}")
    _check_freqs(f)
    for name, x, align in (("re", re, 16), ("im", im, 16),
                           ("mask", mask, 4 * mask.element_size())):
        _check(x.stride(-1) == 1, f"{name}'s last axis must be contiguous")
        _check(all(s % 4 == 0 for s, n in zip(x.stride()[:-1], x.shape[:-1]) if n > 1),
               f"{name}'s strides {x.stride()} must be multiples of 4 elements")
        _check(x.data_ptr() % align == 0, f"{name} must be {align}-byte aligned")
    return b, n_in, mask.shape[2], t, t_use, f


def _device_index(x: torch.Tensor) -> int:
    return x.device.index if x.device.index is not None else torch.cuda.current_device()


def _raise_on(err: int, lib, what: str):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({lib.sag_cuda_error_string(err).decode()})")


def _launch(re, im, mask, n_overlap, precision):
    global launch_count
    b, n_in, tracks, t, t_use, f = _check_inputs(re, im, mask, n_overlap)
    lib = _library()
    b_hi, b_lo = mma_basis(f, re.device, "fwd", precision)
    out_len = (t_use // n_overlap) * f - (n_overlap - 1) * (f // n_overlap)
    out = torch.empty((b, n_in, tracks, out_len), dtype=torch.float32,
                      device=re.device)
    stream = torch.cuda.current_stream(re.device)
    err = lib.sag_masked_istft_fwd(
        re.data_ptr(), im.data_ptr(), mask.data_ptr(),
        int(mask.dtype == torch.bfloat16), PRECISIONS[precision],
        b_hi.data_ptr(), b_lo.data_ptr(), out.data_ptr(), b * n_in, tracks, t_use, f,
        _bn_stride(re), re.stride(2), _bn_stride(im), im.stride(2),
        _bn_stride(mask), mask.stride(2), mask.stride(3),
        _device_index(re), stream.cuda_stream)
    _raise_on(err, lib, "masked_istft")
    launch_count += 1
    return out


def _launch_bwd(re, im, mask, g, n_overlap, precision):
    global bwd_launch_count
    b, n_in, tracks, t, t_use, f = _check_inputs(re, im, mask, n_overlap)
    out_len = (t_use // n_overlap) * f - (n_overlap - 1) * (f // n_overlap)
    _check(g.shape == (b, n_in, tracks, out_len), f"g must be (B, n_in, TR, out_len) = "
           f"{(b, n_in, tracks, out_len)}, got {tuple(g.shape)}")
    _check(g.dtype == torch.float32, f"g must be float32, got {g.dtype}")
    _check(g.is_contiguous(), "g must be contiguous")
    _check(g.data_ptr() % 16 == 0, "g must be 16-byte aligned")
    lib = _library()
    b_hi, b_lo = mma_basis(f, re.device, "bwd", precision)
    d_mask = torch.empty(mask.shape, dtype=mask.dtype, device=re.device)
    d_re = torch.empty((b, n_in, t, f), dtype=torch.float32, device=re.device)
    d_im = torch.empty_like(d_re)
    if t_use != t:   # the dropped trailing frames: zero gradient
        for x in (d_mask[..., t_use:, :], d_re[..., t_use:, :], d_im[..., t_use:, :]):
            x.zero_()
    stream = torch.cuda.current_stream(re.device)
    err = lib.sag_masked_istft_bwd(
        g.data_ptr(), re.data_ptr(), im.data_ptr(), mask.data_ptr(),
        int(mask.dtype == torch.bfloat16), PRECISIONS[precision],
        b_hi.data_ptr(), b_lo.data_ptr(),
        d_mask.data_ptr(), d_re.data_ptr(), d_im.data_ptr(),
        b * n_in, tracks, t_use, t, f,
        _bn_stride(re), re.stride(2), _bn_stride(im), im.stride(2),
        _bn_stride(mask), mask.stride(2), mask.stride(3),
        _device_index(re), stream.cuda_stream)
    _raise_on(err, lib, "masked_istft_bwd")
    bwd_launch_count += 1
    return d_re, d_im, d_mask


def nhwc_vector_route(mask: torch.Tensor, t_use: int) -> bool:
    """Whether K3 takes its vector route on this (B, T, F, TR) mask: the
    tracks of every block come in aligned groups of 4 contiguous values
    (TR and the tracks per block multiples of 4, the other strides
    multiples of 4 elements, the base aligned to 4 elements). Otherwise
    it loads each mask value alone."""
    v = NHWC_VEC_TRACKS
    # a block's tracks (istft_mma.cuh Rows): whole tracks per 64-row
    # warpgroup tile, two tiles; one track when T > 64
    per_block = (64 // t_use) * 2 if t_use <= 64 else 1
    return (per_block % v == 0 and mask.shape[3] % v == 0
            and mask.stride(3) == 1
            and all(st % v == 0 for st, n in zip(mask.stride()[:3], mask.shape[:3]) if n > 1)
            and mask.data_ptr() % (v * mask.element_size()) == 0)


def _check_nhwc_inputs(re, im, mask, n_overlap):
    """Checks what K3 takes; returns (b, tracks, t_use, f)."""
    _check(n_overlap == 4, f"n_overlap must be 4, got {n_overlap}")
    _check(re.dtype == im.dtype == torch.float32, f"re/im must be float32, got "
           f"{re.dtype}/{im.dtype}")
    _check(mask.dtype in (torch.float32, torch.bfloat16),
           f"mask must be float32 or bfloat16, got {mask.dtype}")
    _check(re.dim() == 3 and im.shape == re.shape, f"re/im must be (B, T, F) of one "
           f"shape, got {tuple(re.shape)}/{tuple(im.shape)}")
    b, t, f = re.shape
    _check(mask.dim() == 4 and mask.shape[:3] == (b, t, f),
           f"mask must be (B, T, F, TR) = ({b}, {t}, {f}, TR), got {tuple(mask.shape)}")
    tracks = mask.shape[3]
    t_use = (t // n_overlap) * n_overlap
    _check(t_use >= n_overlap, f"needs at least {n_overlap} frames, got {t}")
    _check_freqs(f)
    for name, x in (("re", re), ("im", im)):
        _check(x.stride(-1) == 1, f"{name}'s last axis must be contiguous")
        _check(all(st % 4 == 0 for st, n in zip(x.stride()[:-1], x.shape[:-1]) if n > 1),
               f"{name}'s strides {x.stride()} must be multiples of 4 elements")
        _check(x.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    return b, tracks, t_use, f


def _launch_nhwc(re, im, mask, n_overlap, precision):
    global nhwc_launch_count
    b, tracks, t_use, f = _check_nhwc_inputs(re, im, mask, n_overlap)
    lib = _library()
    b_hi, b_lo = mma_basis(f, re.device, "fwd", precision)
    out_len = (t_use // n_overlap) * f - (n_overlap - 1) * (f // n_overlap)
    out = torch.empty((b, tracks, out_len), dtype=torch.float32, device=re.device)
    stream = torch.cuda.current_stream(re.device)
    err = lib.sag_masked_istft_nhwc_fwd(
        re.data_ptr(), im.data_ptr(), mask.data_ptr(),
        int(mask.dtype == torch.bfloat16), PRECISIONS[precision],
        int(nhwc_vector_route(mask, t_use)), b_hi.data_ptr(), b_lo.data_ptr(),
        out.data_ptr(), b, tracks, t_use, f,
        re.stride(0), re.stride(1), im.stride(0), im.stride(1),
        *mask.stride(), _device_index(re), stream.cuda_stream)
    _raise_on(err, lib, "masked_istft_nhwc")
    nhwc_launch_count += 1
    return out


def _find_nvcc() -> str:
    candidates = [os.path.join(os.environ[k], "bin", "nvcc")
                  for k in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(k)]
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found (looked at $CUDA_HOME, $CUDA_PATH, PATH "
                       "and /usr/local/cuda/bin); it is needed to build "
                       f"{', '.join(src.name for src in SOURCES)}")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    tag = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        tag.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libsag_masked_istft_{tag.hexdigest()[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the kernel library unless it exists: one nvcc per source,
    all started together, then one link.

    Returns (path, build seconds, nvcc's output); seconds is 0.0 and the
    output empty when the library for these sources was already built. The
    output carries ptxas' register, shared-memory and spill report."""
    so = library_path()
    if so.exists():
        return so, 0.0, ""
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in SOURCES:
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    report = []
    try:
        for cmd, _, proc in jobs:
            out, _ = proc.communicate()
            report.append(out)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                                   f"{' '.join(cmd)}\n{out}")
        tmp = so.with_name(f"{tag}.so.tmp")
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        report.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed with exit code {proc.returncode}:\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)   # atomic: a concurrent process never loads half a file
    finally:
        for _, obj, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            obj.unlink(missing_ok=True)
    return so, time.perf_counter() - t0, "".join(report)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    so, _, _ = build()
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sag_masked_istft_fwd.argtypes = [
        ptr, ptr, ptr, i32, i32, ptr, ptr, ptr,     # re im mask bf16 precision B_hi B_lo out
        i32, i32, i32, i32,                         # n_bn tracks T F
        i64, i64, i64, i64, i64, i64, i64,          # strides
        i32, ptr]                                   # device, stream
    lib.sag_masked_istft_fwd.restype = i32
    lib.sag_masked_istft_bwd.argtypes = [
        ptr, ptr, ptr, ptr, i32, i32, ptr, ptr,     # g re im mask bf16 precision B_hi B_lo
        ptr, ptr, ptr,                              # d_mask d_re d_im
        i32, i32, i32, i32, i32,                    # n_bn tracks T T_total F
        i64, i64, i64, i64, i64, i64, i64,          # strides
        i32, ptr]                                   # device, stream
    lib.sag_masked_istft_bwd.restype = i32
    lib.sag_masked_istft_nhwc_fwd.argtypes = [
        ptr, ptr, ptr, i32, i32, i32, ptr, ptr, ptr,   # re im mask bf16 precision vec B_hi B_lo out
        i32, i32, i32, i32,                         # n_b tracks T F
        i64, i64, i64, i64, i64, i64, i64, i64,     # strides
        i32, ptr]                                   # device, stream
    lib.sag_masked_istft_nhwc_fwd.restype = i32
    lib.sag_cuda_error_string.argtypes = [i32]
    lib.sag_cuda_error_string.restype = ctypes.c_char_p
    return lib
