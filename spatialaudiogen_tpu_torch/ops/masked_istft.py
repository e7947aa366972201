"""Fused masked comb-ISTFT (K1): the CUDA kernel's wrapper, its plain
PyTorch version, and the kernel's build.

`masked_istft` is the counterpart of
spatialaudiogen_tpu.ops.pallas_kernels.masked_istft_pallas (same inputs and
output; `interpret` has no counterpart). For CUDA tensors it launches the
hand-written kernel in csrc/masked_istft.cu; for CPU tensors it runs
`masked_istft_plain`, the counterpart of `masked_istft_reference`. There is
no fallback between the two: a CUDA input the kernel cannot take raises.

The kernel is compiled with nvcc at first use into `build/` beside this
file (`.gitignore` lists it) and rebuilt when the source's hash changes.
It is a plain C entry point loaded with ctypes, so the build needs no
PyTorch headers and takes seconds.
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

from spatialaudiogen_tpu_torch.ops.dft import basis, istft_real

SOURCE = Path(__file__).parent / "csrc" / "masked_istft.cu"
BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
ROWS_PER_BLOCK = 128   # the kernel's BM: (track, frame) rows one block stages at a time
MAX_SMEM = 232448      # bytes of shared memory one block may use on Hopper

# Launches of the CUDA kernel (never of the plain version); read and reset
# by callers that need to show the main path went through the kernel.
launch_count = 0


def masked_istft_plain(re: torch.Tensor, im: torch.Tensor, mask: torch.Tensor,
                       n_overlap: int = 4) -> torch.Tensor:
    """Plain PyTorch version: istft_real of the masked spectra, in the
    dtype of re/im (float32 on the model's path).

    re, im: (B, n_in, T, F); mask: (B, n_in, TR, T, F) -> (B, n_in, TR, out_len)."""
    mask = mask.to(re.dtype)
    return istft_real(re[:, :, None] * mask, im[:, :, None] * mask, n_overlap)


def masked_istft(re: torch.Tensor, im: torch.Tensor, mask: torch.Tensor,
                 n_overlap: int = 4, precision: str = "highest") -> torch.Tensor:
    """Fused masked comb-ISTFT.

    re, im: (B, n_in, T, F) float32 spectra; mask: (B, n_in, TR, T, F)
    float32 or bfloat16. Returns (B, n_in, TR, out_len) float32 track
    waveforms, out_len = (T//4)*F - 3*F/4. Trailing frames beyond a multiple
    of n_overlap are dropped, as istft_real does. `precision` is accepted
    for parity with masked_istft_pallas; the kernel runs FP32 FMAs for both
    values.
    """
    if precision not in ("highest", "default"):
        raise ValueError(f"precision must be 'highest' or 'default', got {precision!r}")
    devices = {re.device, im.device, mask.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {sorted(map(str, devices))}")
    device = re.device
    if device.type == "cpu":
        return masked_istft_plain(re, im, mask, n_overlap)
    if device.type != "cuda":
        raise ValueError(f"masked_istft runs on CPU or CUDA tensors, got {device}")
    return _launch(re, im, mask, n_overlap)


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


def _launch(re, im, mask, n_overlap):
    global launch_count
    _check(n_overlap == 4, f"n_overlap must be 4, got {n_overlap}")
    _check(not (re.requires_grad or im.requires_grad or mask.requires_grad),
           "no backward yet: call under torch.no_grad() (the fused backward "
           "comes with the train step)")
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
    tracks = mask.shape[2]
    t_use = (t // n_overlap) * n_overlap
    _check(t_use >= n_overlap, f"needs at least {n_overlap} frames, got {t}")
    _check(f % (4 * 32) == 0, f"F must be a multiple of 128, got {f}")
    for name, x, align in (("re", re, 16), ("im", im, 16),
                           ("mask", mask, 4 * mask.element_size())):
        _check(x.stride(-1) == 1, f"{name}'s last axis must be contiguous")
        _check(all(s % 4 == 0 for s, n in zip(x.stride()[:-1], x.shape[:-1]) if n > 1),
               f"{name}'s strides {x.stride()} must be multiples of 4 elements")
        _check(x.data_ptr() % align == 0, f"{name} must be {align}-byte aligned")

    lib = _library()
    tpb = min(tracks, max(1, ROWS_PER_BLOCK // t_use))
    smem = lib.sag_masked_istft_smem_bytes(tpb, t_use)
    _check(smem <= MAX_SMEM, f"T={t_use} frames need {smem} bytes of shared "
           f"memory per block, more than {MAX_SMEM}")
    c, s = basis(f, re.device)
    out_len = (t_use // n_overlap) * f - (n_overlap - 1) * (f // n_overlap)
    out = torch.empty((b, n_in, tracks, out_len), dtype=torch.float32,
                      device=re.device)
    stream = torch.cuda.current_stream(re.device)
    err = lib.sag_masked_istft_fwd(
        re.data_ptr(), im.data_ptr(), mask.data_ptr(),
        int(mask.dtype == torch.bfloat16), c.data_ptr(), s.data_ptr(),
        out.data_ptr(), b * n_in, tracks, t_use, f, tpb,
        _bn_stride(re), re.stride(2), _bn_stride(im), im.stride(2),
        _bn_stride(mask), mask.stride(2), mask.stride(3),
        re.device.index if re.device.index is not None else torch.cuda.current_device(),
        stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"masked_istft kernel launch failed: CUDA error {err} "
                           f"({lib.sag_cuda_error_string(err).decode()})")
    launch_count += 1
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
                       f"{SOURCE.name}")


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libsag_masked_istft_{tag.hexdigest()[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the kernel library unless it exists.

    Returns (path, build seconds, nvcc's output); seconds is 0.0 and the
    output empty when the library for this source was already built. The
    output carries ptxas' register, shared-memory and spill report."""
    so = library_path()
    if so.exists():
        return so, 0.0, ""
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)   # atomic: a concurrent process never loads half a file
    return so, seconds, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    so, _, _ = build()
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sag_masked_istft_fwd.argtypes = [
        ptr, ptr, ptr, i32, ptr, ptr, ptr,          # re im mask bf16 C S out
        i32, i32, i32, i32, i32,                    # n_bn tracks T F tracks/block
        i64, i64, i64, i64, i64, i64, i64,          # strides
        i32, ptr]                                   # device, stream
    lib.sag_masked_istft_fwd.restype = i32
    lib.sag_masked_istft_smem_bytes.argtypes = [i32, i32]
    lib.sag_masked_istft_smem_bytes.restype = i64
    lib.sag_cuda_error_string.argtypes = [i32]
    lib.sag_cuda_error_string.restype = ctypes.c_char_p
    return lib
