"""Build and load the hand-written CUDA kernels.

At first use, ``nvcc`` compiles every ``pysfm_tpu_torch/csrc/*.cu`` for
``sm_90a`` (Hopper), one process per source, all started together, links
the objects into one shared library with a plain C interface, and
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
# Every C entry of the library: name -> (restype, argtypes).  Pointers and
# the stream are c_void_p so ctypes passes them at full width.
_SIGNATURES = {
    # cudaError_t pysfm_noop(stream): the empty kernel (csrc/floor.cu)
    "pysfm_noop": (ctypes.c_int, [_P]),
    # cudaError_t pysfm_proj_cm(model, robust, R, t, intr, X, obs_cam,
    #     obs_pt, uv, w, fixed, scale, M, vec_mode, rt, Jct, Jpt, wt, stream)
    "pysfm_proj_cm": (
        ctypes.c_int,
        [ctypes.c_int, ctypes.c_int] + [_P] * 10 + [ctypes.c_int] * 2 + [_P] * 5,
    ),
    # cudaError_t pysfm_build_eqs(model, robust, rows_bf16, ctab, C, X3, P,
    #     obs_cam, obs_pt, u, v, w, pt_ptr, tile_pt, n_tiles, tile_obs,
    #     cam_perm, cam_pt, u_cam, v_cam, w_cam, chunk_off, n_chunks,
    #     chunk_ptr, scale, M, partial, b_rows, b_cam, Hcc, g_c, hpp6, g_p,
    #     stream)
    "pysfm_build_eqs": (
        ctypes.c_int,
        [ctypes.c_int] * 3 + [_P, ctypes.c_int, _P, ctypes.c_int] + [_P] * 7
        + [ctypes.c_int] * 2 + [_P] * 6 + [ctypes.c_int] + [_P] * 2 + [ctypes.c_int]
        + [_P] * 8,
    ),
    # cudaError_t pysfm_payload_b(model, robust, rows_bf16, ctab, C, X3, P,
    #     obs_cam, obs_pt, u, v, w, scale, M, b_rows, stream)
    "pysfm_payload_b": (
        ctypes.c_int,
        [ctypes.c_int] * 3 + [_P, ctypes.c_int, _P, ctypes.c_int] + [_P] * 6
        + [ctypes.c_int] + [_P] * 2,
    ),
    # cudaError_t pysfm_cost(model, robust, ctab, C, X3, P, obs_cam, obs_pt,
    #     u, v, w, scale, M, partial, n_partial, ticket, out, stream)
    "pysfm_cost": (
        ctypes.c_int,
        [ctypes.c_int] * 2 + [_P, ctypes.c_int, _P, ctypes.c_int] + [_P] * 6
        + [ctypes.c_int, _P, ctypes.c_int] + [_P] * 3,
    ),
    # cudaError_t pysfm_hcpT_x(cp, rows_bf16, b_rows, x, C, obs_cam, pt_ptr,
    #     P, tile_pt, n_tiles, tile_obs, M, x_mode, u, stream)
    "pysfm_hcpT_x": (
        ctypes.c_int,
        [ctypes.c_int] * 2 + [_P] * 2 + [ctypes.c_int] + [_P] * 2 + [ctypes.c_int, _P]
        + [ctypes.c_int] * 4 + [_P] * 2,
    ),
    # cudaError_t pysfm_hcp_w(cp, rows_bf16, b_cam, w3, P, cam_pt, chunk_off,
    #     n_chunks, chunk_ptr, C, M, partial, y, stream)
    "pysfm_hcp_w": (
        ctypes.c_int,
        [ctypes.c_int] * 2 + [_P] * 2 + [ctypes.c_int] + [_P] * 2 + [ctypes.c_int, _P]
        + [ctypes.c_int] * 2 + [_P] * 3,
    ),
    # cudaError_t pysfm_precond_diag(cp, rows_bf16, b_cam, hinv6, P, hinv_pt,
    #     cam_pt, chunk_off, n_chunks, chunk_ptr, C, M, partial, D, stream)
    "pysfm_precond_diag": (
        ctypes.c_int,
        [ctypes.c_int] * 2 + [_P] * 2 + [ctypes.c_int] + [_P] * 3 + [ctypes.c_int, _P]
        + [ctypes.c_int] * 2 + [_P] * 3,
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


def _run_all(cmds, timeout: float):
    """Run the commands in parallel; returns [(returncode, output)].  Every
    process is ended before this returns, also on a timeout."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
        return [(p.returncode, out) for p, out in zip(procs, outs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


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
    tmp_dir = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        nvcc = _nvcc()
        objs = [tmp_dir / f"{s.stem}.o" for s in sources]
        compile_cmds = [
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o), str(s)]
            for s, o in zip(sources, objs)
        ]
        tmp_lib = tmp_dir / lib.name
        link_cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib), *map(str, objs)]
        t0 = time.perf_counter()
        log = ""
        for cmds in (compile_cmds, [link_cmd]):
            for cmd, (rc, out) in zip(cmds, _run_all(cmds, timeout=900)):
                log += out
                if rc != 0:
                    raise RuntimeError(
                        f"nvcc failed with code {rc}:\n{' '.join(cmd)}\n{out}"
                    )
        seconds = time.perf_counter() - t0
        # Rename into place so a concurrent loader never sees a partial file.
        os.replace(tmp_lib, lib)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    return BuildInfo(lib, seconds, True, log)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build().path))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib
