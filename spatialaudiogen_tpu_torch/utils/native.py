"""Loader for the repo's native C++ library (`native/`: the EMD solver and
the wav and jpeg decoders), the port's copy of
spatialaudiogen_tpu.utils.native.

Builds native/ once per process on demand (make) and configures the ctypes
signatures. Returns None when no toolchain is available: callers keep a
pure-Python decode path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_REPO_ROOT = os.path.realpath(os.path.join(os.path.dirname(__file__), "..", ".."))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libsagnative.so")
_lock = threading.Lock()
_lib = None
_failed = False

_F64P = ctypes.POINTER(ctypes.c_double)
_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int)

# name -> (restype, argtypes). A symbol missing from an older .so only
# disables the paths that use it: callers check has_symbol.
_SIGNATURES = {
    "sag_emd_hat": (ctypes.c_double,
                    [ctypes.c_int32, ctypes.c_int32, _F64P, _F64P, _F64P,
                     ctypes.c_double]),
    "sag_emd_hat_batch": (None,
                          [ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                           _F64P, _F64P, _F64P, ctypes.c_double, _F64P]),
    "sag_decode_wav": (ctypes.c_long,
                       [ctypes.c_char_p, ctypes.c_int, ctypes.c_long, _F32P]),
    "sag_jpeg_probe": (ctypes.c_int, [ctypes.c_char_p, _I32P, _I32P, _I32P]),
    "sag_jpeg_decode_batch": (ctypes.c_int,
                              [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P]),
    "sag_jpeg_decode_batch_yuv420": (ctypes.c_int,
                                     [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, _U8P]),
}


def has_symbol(lib, name: str) -> bool:
    """True if the loaded library exports `name` (configured signature)."""
    return lib is not None and name in getattr(lib, "_sag_symbols", ())


def load_native():
    """Build (if needed) and load libsagnative; None on failure.

    A failed rebuild (e.g. missing libjpeg on the host) falls back to the
    existing .so rather than disabling native paths that already worked.
    """
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            stale = not os.path.exists(_LIB_PATH)
            if not stale:
                lib_mtime = os.path.getmtime(_LIB_PATH)
                for sub in ("emd", "loader"):
                    subdir = os.path.join(_NATIVE_DIR, sub)
                    stale = stale or any(
                        os.path.getmtime(os.path.join(subdir, fn)) > lib_mtime
                        for fn in os.listdir(subdir) if fn.endswith(".cpp"))
            if stale:
                try:
                    subprocess.run(["make", "-B", "-C", _NATIVE_DIR], check=True,
                                   capture_output=True, timeout=180)
                except (OSError, subprocess.SubprocessError):
                    if not os.path.exists(_LIB_PATH):
                        raise
                    # keep serving the existing (possibly older) library
            lib = ctypes.CDLL(_LIB_PATH)
            available = []
            for name, (restype, argtypes) in _SIGNATURES.items():
                try:
                    fn = getattr(lib, name)
                except AttributeError:
                    continue
                fn.restype = restype
                fn.argtypes = argtypes
                available.append(name)
            if "sag_emd_hat" not in available:  # every shipped .so has the EMD core
                raise OSError(f"{_LIB_PATH} exports no sag_emd_hat")
            lib._sag_symbols = tuple(available)
            _lib = lib
        except (OSError, subprocess.SubprocessError):
            _failed = True
            _lib = None
        return _lib
