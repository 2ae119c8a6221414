"""Build and load the hand-written CUDA kernels.

At first use, ``nvcc`` compiles every ``pysfm_tpu_torch/csrc/*.cu`` into
one shared library with a plain C interface, for ``sm_90a`` (Hopper), and
``ctypes`` loads it.  The library lands in ``build/`` at the root of the
checkout, named by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  A failed build raises.

No ``--use_fast_math``: the kernels' f32 tolerances assume IEEE division
and square root.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
# Every C entry of the library: name -> (restype, argtypes).  Pointers and
# the stream are c_void_p so ctypes passes them at full width.
_SIGNATURES = {
    # cudaError_t pysfm_proj_cm(model, robust, R, t, intr, X, obs_cam,
    #     obs_pt, uv, w, free_c, scale, M, rt, Jct, Jpt, wt, stream)
    "pysfm_proj_cm": (
        ctypes.c_int,
        [ctypes.c_int, ctypes.c_int] + [_P] * 10 + [ctypes.c_int] + [_P] * 5,
    ),
}


class BuildInfo(NamedTuple):
    path: Path
    seconds: float  # nvcc wall time; 0.0 when an existing library was loaded
    built: bool
    log: str        # nvcc's output, ptxas register/spill report included


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        found = cand if os.path.exists(cand) else None
    if found is None:
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME): the CUDA kernels cannot be built"
        )
    return found


@functools.lru_cache(maxsize=None)
def build() -> BuildInfo:
    """Compile ``csrc/*.cu`` into ``build/`` unless an up-to-date library
    is already there."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    lib = BUILD_DIR / f"libpysfm_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return BuildInfo(lib, 0.0, False, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           *(str(s) for s in sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    # Rename into place so a concurrent loader never sees a partial file.
    os.replace(tmp, lib)
    return BuildInfo(lib, seconds, True, proc.stdout + proc.stderr)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build().path))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib
