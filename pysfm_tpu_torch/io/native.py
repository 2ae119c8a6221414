"""ctypes bindings for the native I/O tier (``_native/fast_parse.cpp``).

Host code: a whitespace tokenizer and a BAL body writer in C++.  At first
use ``g++ -O3 -shared -fPIC`` builds the library into ``build/`` at the
root of the checkout (beside the CUDA kernels), named by a hash of the
source and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  Every entry point has a NumPy fallback, so a machine
without a C++ compiler still reads and writes the files, more slowly;
:func:`have_native` says which one runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from pysfm_tpu_torch.solver.kernels._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "_native" / "fast_parse.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    """Where the library for this source and these flags lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"libpysfm_io_{digest.hexdigest()[:16]}.so"


def _build(lib: Path) -> bool:
    """Compile into a temporary file and rename it into place, so a
    concurrent loader never sees a partial library."""
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
        os.close(fd)
        try:
            subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", tmp],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        lib_path = library_path()
        if not lib_path.exists() and not _build(lib_path):
            return None
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError:
            return None
        lib.pysfm_parse_doubles.restype = ctypes.c_int64
        lib.pysfm_parse_doubles.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ]
        lib.pysfm_count_tokens.restype = ctypes.c_int64
        lib.pysfm_count_tokens.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.pysfm_format_bal.restype = ctypes.c_int64
        lib.pysfm_format_bal.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def have_native() -> bool:
    return _load() is not None


def parse_doubles(data: bytes, expected: Optional[int] = None) -> np.ndarray:
    """Parse whitespace-separated numbers from ``data`` into a f64 array.

    Uses the C++ tokenizer when available (one pass, no Python string
    objects); falls back to ``np.array(data.split())``.  ``expected`` caps
    the output size when the caller knows the token count (skips the
    counting pass).
    """
    lib = _load()
    if lib is None:
        out = np.array(data.split(), dtype=np.float64)
        return out[:expected] if expected is not None else out
    # ctypes c_char_p passes the bytes' own NUL-terminated buffer; strtod
    # never reads past it.
    if expected is None:
        expected = int(lib.pysfm_count_tokens(data, len(data)))
    out = np.empty(expected, dtype=np.float64)
    n = lib.pysfm_parse_doubles(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), expected,
    )
    return out[:n]


def format_bal(
    obs_cam: np.ndarray,
    obs_pt: np.ndarray,
    uv: np.ndarray,
    vals: np.ndarray,
) -> Optional[bytes]:
    """Format the BAL body (observation lines, then one value per line at
    %.17g) with the native writer; None when the library is unavailable
    (the caller then formats with NumPy)."""
    lib = _load()
    if lib is None:
        return None
    obs_cam = np.ascontiguousarray(obs_cam, np.int32)
    obs_pt = np.ascontiguousarray(obs_pt, np.int32)
    uv = np.ascontiguousarray(uv, np.float64)
    vals = np.ascontiguousarray(vals, np.float64)
    n_obs, n_vals = obs_cam.shape[0], vals.shape[0]
    cap = 80 * n_obs + 32 * n_vals + 64
    buf = ctypes.create_string_buffer(cap)
    n = lib.pysfm_format_bal(
        obs_cam.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        obs_pt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        uv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n_obs,
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n_vals,
        buf, cap,
    )
    if n < 0:
        return None  # capacity overflow (cannot happen with the bound above)
    return buf.raw[:n]
