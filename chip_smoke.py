#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main paths once on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. environment: torch, CUDA, nvcc and the card (name, power limit);
2. build: nvcc compiles ``pysfm_tpu_torch/csrc/*.cu`` for sm_90a, one
   process per source, all at once;
3. [kernel] the projection kernel against its plain PyTorch version: every
   camera model x robust kernel on a small scene with a ragged observation
   count, and the dense path's shape (50 cameras, 10k points, ~164k
   observations), where each of its two branches (4 observations a thread
   in vectors, one a thread) is held to the plain version and bitwise to
   itself over two launches, the agreement between the branches is
   counted, and both are timed beside the empty kernel (``csrc/floor.cu``:
   the floor under every kernel time);
4. [main] the dense path: ``solve()`` with the default ``LMConfig`` route
   (dense component-major Schur LM) for 30 iterations on the 50-camera /
   10k-point Huber scene, checked against the plain route on the card and,
   on a small scene, against the f64 route on the host; then [speed];
5. [std] the standard-layout dense path: ``solve()`` with
   ``LMConfig(layout="std")`` (the std wrapper of the projection kernel,
   ``solver/schur.py``) on the same scene, checked against the cm route on
   the card and, on a small scene, against the f64 std route on the host;
   the two-view scene of ``examples/two_view_ba.py`` to its noise floor;
6. [spmv kernels] the six kernels of the pcg route (K_E ``build_eqs``,
   K_D ``payload_b``, K_C ``cost``, ``hcpT_x``, ``hcp_w``, K_H
   ``precond_diag``) against their plain versions on small ragged scenes
   (also one with C > 128): 3 camera models x 3 robust kernels, f32 and bf16
   coupling rows; K_D against K_E's rows too, K_E's camera-sorted rows
   ``b_cam`` bitwise ``b_rows[:, cam_perm]``, K_C bitwise equal over two
   launches with its ticket counter back at 0 after every call, and the
   projection kernel on the same observations (both branches, as in
   [kernel]); then on the edge shapes of
   the plans (``synthetic.PLAN_EDGES``: a camera without observations,
   cameras with more than one chunk, points longer than a tile, x too large
   for shared memory) for CP 6 / 9 / 10: the two CG products and K_H on
   random rows, ``hcpT_x`` in both branches (x in shared memory, x from
   global memory) and bitwise equal across them, and all six kernels on a
   scene built on the same observations (``synthetic.plan_edge_scene``);
   two launches must agree bit for bit, f64 tensors must be refused, and
   ``hcp_w`` and K_H without ``b_cam`` must raise;
7. [pcg main] the pcg path: ``solve(cm.from_problem(p), LMConfig(solver=
   "pcg", cg_forcing="ew", ...), gops=make_grouped_ops(...))`` on the
   bench.py headline scene (the same 50 / 10k scene), 30 iterations, with
   the exact launch count of every kernel checked against the LM and CG
   logs, the final cost against the plain route on the card and, on a small
   scene, against the f64 host route; then a torch.profiler trace of one
   solve (device idle share) and each kernel's time at that shape (with
   ``b_cam`` bitwise ``b_rows[:, cam_perm]`` there), beside the bound and
   the empty kernel's time;
8. [proj venice] the projection kernel at the Venice scene's M (~5.0M
   observations, std layout; no dense route solves at that size): each
   branch against its plain version and bitwise against itself, the
   agreement between the branches counted, and timed;
9. [pcg venice] the same route on the Venice-scale synthetic BAL scene
   (1712 cameras, 1M points, ~5M observations): kernels against plain at
   that shape, their times, 18 LM iterations with bench/venice.py's
   settings, and a torch.profiler trace of them;
10. [bal io] the BAL-file path of ``bench/io_scale.py`` (428 cameras, 125k
   points, camera model "bal"): ``save_bal``, ``load_bal`` onto the card
   through the native tokenizer, a segmented pcg solve with the kernels,
   and a checkpoint at the half whose resumed cost log must equal the tail
   of the straight solve to 1e-5;
11. [incremental] BASELINE config 2 as bench.py runs it: an f32 track
   table of 10 keyframes and 1k points through ``run_incremental`` on the
   card, twice (frames/s of each run, the fenced stage times), under the
   gates of tests/test_pipeline.py, with at least one projection-kernel
   launch per BA solve; after each run the projection kernel is held to
   its plain version on every problem the run gave its BA solves and on
   its final problem; the same scene as an f64 table (the plain route, no
   launch) on the card and on the host, both drawing their minimal sets
   from one host generator, which must give the same init pair and PnP
   inlier lists and camera centres within 1e-9;
12. [incremental scale] bench/incremental_scale.py's scene (50 keyframes,
   2k points, visibility 0.35) as an f32 track table, twice: every frame
   registered, ATE < 2e-2, at least one projection-kernel launch per BA
   solve, the kernel held to its plain version on the run's problems as in
   11, frames/s and the fenced stage times; then a third run under
   torch.profiler for the device's idle share;
13. [images] tests/test_tracks.py's dot video (6 frames of 160x220)
   through ``run_from_images`` on the card under that test's gates, then
   ``detect_and_describe`` + ``match_descriptors`` on a 480x640 frame pair:
   f64 on the card against f64 on the host (the same keypoint sets, xy and
   descriptors within 1e-9), and the f32 time on the card;
14. [dist venice] (run right after 9, on its scene) the distributed pcg route (``dist.solve_sharded_cm`` with
   the kernels on the shard's own ``GroupedOps``) on the Venice-scale scene
   in a world of one rank over NCCL, without and with the camera partition:
   the cost log and CG counts of [pcg venice] (bitwise, or within 1e-6 with
   equal CG counts, as printed), launches equal to the logs, ms per LM
   iteration beside [pcg venice]'s, the collectives' calls and bytes, peak
   memory; then ``dist.solve_sharded``'s dense route on the headline scene
   (f32: the projection kernel on the shard, held to plain there, one launch
   an LM iteration, costs within 1e-6 of [main]);
15. [dist ranks] (run right after 14) two ranks on the one card over gloo with CUDA tensors
   (NCCL refuses two ranks on one device), each building only its own shard
   of [bal io]'s scene in the cm layout (~313k observations a rank): f32
   with the kernels, without and with the camera partition, within 1e-3 of
   the single-device kernel solve; f64 on the plain route within 1e-9 with
   equal CG counts; on rank 0's shard K_E, K_C, ``hcpT_x``, ``hcp_w`` and K_H
   held to their plain versions; each rank's launches against its logs.
   gloo's reduce-scatter and all-gather run as all-reduces
   (``utils/collectives.py``); the phase says so;
16. [examples] (run last) the four runnable examples of
   ``pysfm_tpu_torch/examples`` on the card through their ``run()``, each
   under its own gate: ``two_view_ba`` (RMSE below twice the noise; one
   projection-kernel launch an LM iteration), ``incremental_sfm`` (every
   frame registered, ATE < 2e-2; one launch an LM iteration of each BA
   solve), ``bal_checkpoint_resume`` with the pcg kernels (the resumed cost
   within 1e-4 of the uninterrupted one; launches equal to the three
   solves' LM/CG logs) and on the JAX script's literal route (no kernel),
   and ``distributed_ba`` as a world of one rank over NCCL (within 1e-4 of
   the single-device trajectory); the kernels held to their plain versions
   on each example's own problems, and each example's wall seconds.

No solve path runs K_D (as in the JAX package): every solve checks that it
launched 0 times.

The second-to-last lines are the card's ``nvidia-smi`` name and power
limit and one JSON object describing each kernel (times at the dense and
headline shapes, and under "venice" at the Venice scene's M, each beside its
bound and the empty kernel's time); the last line is ``{"ok": true,
"device": {...}}``.
Without a CUDA device, or without the ``pysfm_tpu_torch`` package beside
this script, it exits non-zero and prints no result.  Imports nothing of
JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Per-output tolerance of the kernel against its plain version, both f32 on
# the card: max|kernel - plain| <= KERNEL_TOL * (max|plain| + 1).  The two
# round in different orders (FMA contraction, operation order), so errors
# sit at the few-ulp level relative to the largest entry.
KERNEL_TOL = 1e-4
# Final LM cost: kernel route against the plain route (both f32 on the
# card), and f32 card route against the f64 host route on a small scene.
COST_RTOL = 1e-3
N_ITERS = 30
# Sleep-kernel length that keeps the stream busy while the host enqueues
# one timed call (~20 ms at H100 clocks).
SLEEP_CYCLES = 40_000_000
MAIN_SCENE = dict(
    n_cameras=50, n_points=10_000, noise_px=0.5, outlier_frac=0.05,
    outlier_px=40.0, visibility=0.3, robust="huber", robust_scale=2.0,
    seed=42, dtype=np.float32,
)
NO_TOL = dict(tol_grad=0.0, tol_cost_rel=0.0, tol_step=0.0)
# The pcg route as bench.py drives it (headline) and as bench/venice.py
# drives it at BAL scale.
PCG_MAIN = dict(solver="pcg", cg_iters=25, cg_tol=1e-2, cg_forcing="ew", cg_q_tol=0.3)
PCG_VENICE = dict(solver="pcg", cg_iters=25, cg_tol=1e-2, cg_forcing="ew", cg_q_tol=0.1)
VENICE_SCENE = dict(
    n_cameras=1712, n_points=1_000_000, mean_track=5.0, max_track=12,
    robust="huber", robust_scale=2.0, noise_px=0.5, seed=4, dtype=np.float32,
    with_truth=False, layout="cm",
)
VENICE_ITERS = 18  # bench/venice.py's default
# bench/io_scale.py's scene and solve.
IO_SCENE = dict(
    n_cameras=428, n_points=125_000, mean_track=5.0, max_track=12, noise_px=0.5,
    camera_model="bal", seed=4, dtype=np.float32, with_truth=False, layout="std",
)
IO_ITERS = 12
RESUME_RTOL = 1e-5
# Roofline of the H100 SXM (data sheet): device memory and non-tensor f32.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# Operations of one projection + analytic Jacobian + weight (project_jac.cuh:
# the 3x3 transform, the division, the 2x3 derivative, the 2x(6+intr) camera
# and 2x3 point Jacobian rows), counted from the source.
LINEARIZE_OPS = 110
SPMV_KERNELS = ("build_eqs", "cost", "hcpT_x", "hcp_w", "precond_diag", "payload_b")
SPMV_SOURCE = {
    "build_eqs": ("pysfm_tpu_torch/csrc/eqs.cu", "pysfm_tpu/solver/kernels/pallas_spmv.py:929"),
    "payload_b": ("pysfm_tpu_torch/csrc/eqs.cu", "pysfm_tpu/solver/kernels/pallas_spmv.py:762"),
    "cost": ("pysfm_tpu_torch/csrc/eqs.cu", "pysfm_tpu/solver/kernels/pallas_spmv.py:1149"),
    "hcpT_x": ("pysfm_tpu_torch/csrc/spmv.cu", "pysfm_tpu/solver/kernels/pallas_spmv.py:569"),
    "hcp_w": ("pysfm_tpu_torch/csrc/spmv.cu", "pysfm_tpu/solver/kernels/pallas_spmv.py:654"),
    "precond_diag": ("pysfm_tpu_torch/csrc/spmv.cu", "pysfm_tpu/solver/kernels/pallas_spmv.py:1046"),
}

# The dot video of tests/test_tracks.py: a camera translating past 120
# textured 3-D points, 6 frames of 160 x 220, rendered by bilinear
# splatting (subpixel truth).
DOT_H, DOT_W, DOT_F, DOT_TEX = 160, 220, 180.0, 5
# A camera-size frame pair for the front end alone.
CAMERA_FRAME = (480, 640)


def render_dots(points_px: np.ndarray, textures: np.ndarray, shape=(DOT_H, DOT_W)) -> np.ndarray:
    """Splat a TEX x TEX texture per point with bilinear subpixel placement
    (tests/test_tracks.py's ``_render``, vectorised: ``np.add.at`` adds in
    the loop's order, so the image is the same bit for bit)."""
    H, W = shape
    r = DOT_TEX // 2
    x, y = points_px[:, 0], points_px[:, 1]
    keep = (r + 1 <= x) & (x < W - r - 2) & (r + 1 <= y) & (y < H - r - 2)
    x, y, tex = x[keep], y[keep], textures[keep]
    x0, y0 = np.floor(x).astype(np.int64), np.floor(y).astype(np.int64)
    fx, fy = x - x0, y - y0
    ty, tx, dy, dx = np.meshgrid(*(np.arange(n) for n in (DOT_TEX, DOT_TEX, 2, 2)),
                                 indexing="ij")
    wgt = (np.where(dx, fx[:, None, None, None, None], 1 - fx[:, None, None, None, None])
           * np.where(dy, fy[:, None, None, None, None], 1 - fy[:, None, None, None, None]))
    rows = y0[:, None, None, None, None] + ty - r + dy
    cols = x0[:, None, None, None, None] + tx - r + dx
    img = np.zeros((H, W))
    np.add.at(img, (rows.ravel(), cols.ravel()), (tex[:, :, :, None, None] * wgt).ravel())
    return img


def dot_video(n_frames: int = 6, shape=(DOT_H, DOT_W), n_pts: int = 120, seed: int = 5):
    """(images [F, H, W], camera centers [F, 3], points [n, 3], textures):
    the video of tests/test_tracks.py's ``dot_video`` fixture at its
    defaults; a larger ``shape`` and ``n_pts`` give a camera-size frame
    (the focal length scales with the width, the principal point is the
    centre)."""
    H, W = shape
    focal = DOT_F * W / DOT_W
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
                  rng.uniform(9, 13, n_pts)], axis=-1)
    centers = np.stack([np.linspace(0, 3.0, n_frames), 0.05 * rng.normal(size=n_frames),
                        np.linspace(0, 0.5, n_frames)], axis=-1)
    textures = rng.uniform(0.0, 1.0, (n_pts, DOT_TEX, DOT_TEX))
    images = []
    for c in centers:
        p = X - c  # identity rotation, t = -c
        px = np.stack([focal * p[:, 0] / p[:, 2] + W / 2, focal * p[:, 1] / p[:, 2] + H / 2],
                      axis=-1)
        images.append(render_dots(px, textures, shape))
    return np.stack(images), centers, X, textures


def _import_port():
    if not os.path.isdir(os.path.join(ROOT, "pysfm_tpu_torch")):
        raise SystemExit("chip_smoke.py: pysfm_tpu_torch/ not found beside this script")
    sys.path.insert(0, ROOT)


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_env() -> str:
    from pysfm_tpu_torch.solver.kernels import _build

    nvcc = subprocess.run(
        [_build._nvcc(), "--version"], check=True, capture_output=True,
        text=True, timeout=60,
    ).stdout.strip().splitlines()[-1]
    smi = _smi()
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} | "
          f"nvcc: {nvcc} | card: {smi} | devices {torch.cuda.device_count()}")
    return smi


# Mangled template arguments of the main paths' instantiations: the pose
# model (CP = 6), the Huber kernel, f32 rows; the projection kernel with 4
# observations a thread.
MAIN_PATH_ARGS = ("ILi0ELi1EfE", "ILi6EfE", "ILi0ELi1EE", "ILi0ELi1ELi4EE")


def ptxas_registers(log: str) -> dict:
    """ptxas -v: {(kernel name, mangled template arguments): registers a
    thread} of every kernel instantiation in an nvcc log."""
    regs, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN5pysfm(\d+)(\w+)'", line)
        if m:
            key = (m.group(2)[:int(m.group(1))], m.group(2)[int(m.group(1)):])
        m = re.search(r"Used (\d+) registers", line)
        if m and key:
            regs[key] = int(m.group(1))
            key = None
    return regs


def ptxas_spills(log: str) -> list:
    """ptxas -v: the kernel instantiations (name, mangled template
    arguments) whose spill stores are not 0."""
    spills, key = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN5pysfm(\d+)(\w+)'", line)
        if m:
            key = (m.group(2)[:int(m.group(1))], m.group(2)[int(m.group(1)):int(m.group(1)) + 24])
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and key and m.group(1) != "0":
            spills.append(key)
    return sorted(set(spills))


def main_path_registers(log: str) -> dict:
    """Registers a thread of K_E's two passes, K_H's first pass, K_C and the
    projection kernel as the main paths instantiate them."""
    return {name: r for (name, args), r in sorted(ptxas_registers(log).items())
            if name.startswith(("eqs_", "precond_", "cost_", "proj_"))
            and args.startswith(MAIN_PATH_ARGS)}


def phase_build() -> float:
    from pysfm_tpu_torch.solver.kernels import _build

    info = _build.build()
    _build.library()
    regs = sorted({int(n) for n in re.findall(r"Used (\d+) registers", info.log)})
    spills = ptxas_spills(info.log)
    by_kernel = {}
    for (name, _), r in ptxas_registers(info.log).items():
        by_kernel.setdefault(name, set()).add(r)
    print(f"[build] {info.path.name} built={info.built} nvcc {info.seconds:.2f} s; "
          f"registers/thread {regs}, kernels with spills: {len(spills)} {spills}; by kernel "
          + ", ".join(f"{k} {min(v)}-{max(v)}" for k, v in sorted(by_kernel.items()))
          + f"; main paths (pose, Huber, f32 rows): {main_path_registers(info.log)}")
    return info.seconds


def _max_err(outs, refs):
    """Worst error over the outputs, and whether each is inside its bound."""
    worst, ok = 0.0, True
    for a, b in zip(outs, refs):
        err = float((a - b).abs().max())
        bound = KERNEL_TOL * (float(b.abs().max()) + 1.0)
        worst = max(worst, err)
        ok = ok and err <= bound and bool(torch.isfinite(a).all())
    return worst, ok


def _kernel_vs_plain(p):
    from pysfm_tpu_torch.solver.kernels import proj

    before = proj.LAUNCHES
    outs = proj.residuals_and_jacobians_cm(p)
    torch.cuda.synchronize()
    if proj.LAUNCHES != before + 1:
        raise AssertionError("kernel wrapper did not count exactly one launch")
    refs = proj._plain(p.camera_model, p.robust, *proj._problem_args(p))
    for a, b in zip(outs, refs):
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return _max_err(outs, refs)


def phase_kernel_small() -> None:
    from pysfm_tpu_torch.pipeline import synthetic
    from pysfm_tpu_torch.solver.kernels import proj

    worst = 0.0
    for model in ("pose", "pose_k", "bal"):
        for robust in ("gaussian", "huber", "cauchy"):
            sc = synthetic.make_scene(
                5, 101, camera_model=model, noise_px=1.0, outlier_frac=0.1,
                outlier_px=30.0, robust=robust, robust_scale=2.0, seed=3,
                dtype=np.float32, device="cuda",
            )
            err, ok = _kernel_vs_plain(sc.problem)
            if not ok:
                raise AssertionError(f"{model}/{robust}: kernel disagrees, max err {err}")
            worst = max(worst, err)
        # The std-layout wrapper (JAX signature: gathered operands).
        p = sc.problem
        R, t, intr, X, obs_cam, obs_pt, uv, w, fixed, scale = proj._problem_args(p)
        free = torch.logical_not(fixed).to(uv.dtype)
        outs = proj.residuals_jacobians_weights(
            model, p.robust, R[obs_cam], t[obs_cam], intr[obs_cam], X[obs_pt],
            uv, w, free[obs_cam], scale,
        )
        refs = proj._to_std(*proj.proj_cm_plain(
            model, p.robust, R, t, intr, X, obs_cam, obs_pt, uv, w, free, scale,
        ))
        err, ok = _max_err(outs, refs)
        if not ok:
            raise AssertionError(f"{model}: std-layout wrapper disagrees, max err {err}")
    p64 = synthetic.make_scene(3, 37, seed=5, dtype=np.float64, device="cuda").problem
    try:
        proj.residuals_and_jacobians_cm(p64)
    except TypeError:
        pass
    else:
        raise AssertionError("the kernel wrapper accepted f64 CUDA tensors")
    print(f"[kernel] 3 models x 3 robust kernels at M={p.n_obs} (+ std layout): "
          f"max abs err {worst:.3e} (bound {KERNEL_TOL} x (max|ref|+1))")


def _device_ms(fn, n=20) -> float:
    """Median device time of one call, by CUDA events around each of n calls.

    Each call is enqueued behind a sleep kernel, so the device reaches it
    only after the host has queued all of its launches: the events then time
    the device's work and not the host's launch overhead (which, for a ~7 us
    kernel, is the larger of the two). A call whose enqueueing outlasted the
    sleep (a slow or shared host) is timed again behind a longer sleep.
    """
    fn()
    torch.cuda.synchronize()
    times, cycles = [], SLEEP_CYCLES
    for _ in range(n):
        for _attempt in range(4):
            s0, s1, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
            s0.record()
            torch.cuda._sleep(cycles)
            s1.record()
            t0 = time.perf_counter()
            fn()
            end.record()
            host_ms = (time.perf_counter() - t0) * 1e3
            end.synchronize()
            sleep_ms = s0.elapsed_time(s1)
            if host_ms < sleep_ms:
                break
            cycles = int(cycles * 2 * host_ms / sleep_ms) + 1
        else:
            raise AssertionError(
                f"enqueueing took {host_ms:.2f} ms, longer than the sleep of {sleep_ms:.2f} "
                "ms four times: the events would time host gaps")
        times.append(s1.elapsed_time(end))
    return statistics.median(times)


def noop_call():
    """The empty kernel (``csrc/floor.cu``) as a call for :func:`_device_ms`:
    its time is the floor under every kernel time here."""
    from pysfm_tpu_torch.solver.kernels import _build

    lib = _build.library()

    def call():
        err = lib.pysfm_noop(torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"pysfm_noop launch failed: cudaError_t {err}")
    return call


def _host_ms(fn, n=20) -> float:
    """Median wall time of one call ended by a synchronize (host included)."""
    times = []
    for _ in range(n + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def phase_kernel_main(p, smi: str) -> dict:
    from pysfm_tpu_torch.solver.kernels import proj

    err, ok = _kernel_vs_plain(p)
    if not ok:
        raise AssertionError(f"main-path shape: kernel disagrees, max err {err}")
    args = proj._problem_args(p)
    _, vec, same = _proj_branches("main-path shape", p.camera_model, p.robust, args)
    if not vec:
        raise AssertionError(f"main-path shape M={p.n_obs}: the vector branch did not run")
    ms_v = [_device_ms(lambda v=v: proj._launch_cm(p.camera_model, p.robust, *args, vec=v))
            for v in (True, False, True, False)]
    print(f"[kernel] main-path shape: projection kernel, 4 observations a thread in vectors "
          f"{ms_v[0]:.4f}, {ms_v[2]:.4f} ms; one a thread {ms_v[1]:.4f}, {ms_v[3]:.4f} ms "
          f"(each within bound of plain; same bits: {same}) | {smi}")

    def kernel():
        return proj.residuals_and_jacobians_cm(p)

    def plain():
        return proj._plain(p.camera_model, p.robust, *args)

    floor_ms = _device_ms(noop_call())
    ms, plain_ms = _device_ms(kernel), _device_ms(plain)
    call_ms, plain_call_ms = _host_ms(kernel), _host_ms(plain)
    bound_ms, bound_by = _bound(*_proj_cost(p))
    print(f"[kernel] main-path shape M={p.n_obs}: max abs err {err:.3e}; device time "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 20, CUDA events); "
          f"call with host overhead kernel {call_ms:.4f} ms, plain {plain_call_ms:.4f} ms; "
          f"bound {bound_ms:.4f} ms ({bound_by}), empty-kernel floor {floor_ms:.4f} ms | {smi}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, floor_ms=floor_ms)


def _proj_cost(p):
    """(bytes moved, f32 operations) of one projection-kernel call on
    BundleProblem p: the tables and 20 B an observation in once (ids, uv,
    w), 4 B an output value out once."""
    C, P, M, cp = p.n_cameras, p.n_points, p.n_obs, p.cam_dof
    nbytes = 4 * ((13 + p.intr.shape[1]) * C + 3 * P + 5 * M + 1      # inputs
                  + (2 + 2 * cp + 6 + 1) * M)                         # outputs
    return nbytes, LINEARIZE_OPS * M


def _timed(fn):
    """(fn(), seconds), host clock between two synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _solve_timed(p, cfg, gops=None):
    from pysfm_tpu_torch.solver import solve

    (out, stats), secs = _timed(lambda: solve(p, cfg, gops=gops))
    return out, stats, secs


def _reset_counts():
    """Every kernel's launch count to 0 (just before a path is driven)."""
    from pysfm_tpu_torch.solver.kernels import proj, spmv

    proj.LAUNCHES = 0
    for k in spmv.LAUNCHES:
        spmv.LAUNCHES[k] = 0


def _bound(nbytes: float, ops: float):
    """Least time on the card for the work: the larger of the bytes over the
    memory rate and the f32 operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_main(p):
    from pysfm_tpu_torch.pipeline import synthetic
    from pysfm_tpu_torch.solver import LMConfig, solve
    from pysfm_tpu_torch.solver.kernels import proj

    from pysfm_tpu_torch.solver.kernels import spmv

    cfg = LMConfig(max_iters=N_ITERS, tol_grad=0.0, tol_cost_rel=0.0, tol_step=0.0)
    _reset_counts()
    _, stats, _ = _solve_timed(p, cfg)
    launches = proj.LAUNCHES
    if launches != N_ITERS or any(spmv.LAUNCHES.values()):
        raise AssertionError(f"dense path launched the kernel {launches} times, expected "
                             f"{N_ITERS}, and the pcg kernels {spmv.LAUNCHES} (expected none)")
    costs = stats.costs.cpu().numpy()
    if costs.shape != (N_ITERS + 1,) or not np.all(np.isfinite(costs)):
        raise AssertionError(f"bad cost log {costs}")
    if not costs[N_ITERS] < costs[0]:
        raise AssertionError(f"cost did not decrease: {costs[0]} -> {costs[N_ITERS]}")
    _, st_plain, _ = _solve_timed(p, dataclasses.replace(cfg, jac_backend="torch"))
    c_plain = float(st_plain.costs[-1])
    rel = abs(costs[-1] - c_plain) / abs(c_plain)
    if not rel <= COST_RTOL:
        raise AssertionError(f"kernel route final cost {costs[-1]} vs plain {c_plain} (rel {rel})")

    # Small input: the card's f32 kernel route against the host's f64 plain route.
    small = dict(n_cameras=6, n_points=300, noise_px=0.5, outlier_frac=0.05,
                 outlier_px=40.0, robust="huber", robust_scale=2.0, seed=11)
    small_cfg = dataclasses.replace(cfg, max_iters=10)
    ps = synthetic.make_scene(**small, dtype=np.float32, device="cuda").problem
    ph = synthetic.make_scene(**small, dtype=np.float64, device="cpu").problem
    c_card = float(solve(ps, small_cfg)[1].costs[-1])
    c_host = float(solve(ph, small_cfg)[1].costs[-1])
    rel_small = abs(c_card - c_host) / abs(c_host)
    if not rel_small <= COST_RTOL:
        raise AssertionError(f"small scene: card f32 {c_card} vs host f64 {c_host}")
    print(f"[main] solve() {N_ITERS} iters, M={p.n_obs}: cost {costs[0]:.6e} -> "
          f"{costs[-1]:.6e}, {launches} kernel launches, accepted "
          f"{int(stats.accepted.sum())}/{N_ITERS}; plain route {c_plain:.6e} (rel {rel:.2e}); "
          f"small scene card f32 vs host f64 rel {rel_small:.2e}")
    return launches, costs


def phase_speed(p, smi: str) -> dict:
    from pysfm_tpu_torch.solver import LMConfig

    cfg = LMConfig(max_iters=N_ITERS, tol_grad=0.0, tol_cost_rel=0.0, tol_step=0.0)
    plain_cfg = dataclasses.replace(cfg, jac_backend="torch")
    best = {"kernel": float("inf"), "plain": float("inf")}
    # Alternate the two routes: plain, kernel, kernel, plain, ...
    for order in (("plain", "kernel"), ("kernel", "plain"), ("plain", "kernel")):
        for route in order:
            _, _, secs = _solve_timed(p, cfg if route == "kernel" else plain_cfg)
            best[route] = min(best[route], secs)
    rates = {k: N_ITERS / v for k, v in best.items()}
    print(f"[speed] LM iterations/s (best of 3, {N_ITERS} iters, M={p.n_obs}): "
          f"kernel route {rates['kernel']:.2f}, plain route {rates['plain']:.2f} "
          f"| {smi}")
    return rates


def phase_std(p, smi: str) -> dict:
    """The standard-layout dense path on the main scene, the small scene and
    the two-view scene; returns the std wrapper's timing stats and its
    launches."""
    from pysfm_tpu_torch.pipeline import synthetic
    from pysfm_tpu_torch.problem import problem as problem_mod
    from pysfm_tpu_torch.solver import LMConfig, solve
    from pysfm_tpu_torch.solver.kernels import proj, spmv
    from pysfm_tpu_torch.utils import metrics

    cfg = LMConfig(layout="std", max_iters=N_ITERS, **NO_TOL)
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    _, stats, secs = _solve_timed(p, cfg)
    launches = proj.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    if launches != N_ITERS or any(spmv.LAUNCHES.values()):
        raise AssertionError(f"std path launched the projection kernel {launches} times, "
                             f"expected {N_ITERS}, and the pcg kernels {spmv.LAUNCHES}")
    costs = stats.costs.cpu().numpy()
    if not (np.all(np.isfinite(costs)) and costs[-1] < costs[0]):
        raise AssertionError(f"std path: bad cost log {costs}")
    _, st_cm, _ = _solve_timed(p, dataclasses.replace(cfg, layout="cm"))
    c_cm = float(st_cm.costs[-1])
    rel = abs(costs[-1] - c_cm) / abs(c_cm)
    if not rel <= COST_RTOL:
        raise AssertionError(f"std route final cost {costs[-1]} vs cm route {c_cm}")
    best = secs
    for _ in range(2):
        best = min(best, _solve_timed(p, cfg)[2])

    small = dict(n_cameras=6, n_points=300, noise_px=0.5, outlier_frac=0.05,
                 outlier_px=40.0, robust="huber", robust_scale=2.0, seed=11)
    small_cfg = dataclasses.replace(cfg, max_iters=10)
    ps = synthetic.make_scene(**small, dtype=np.float32, device="cuda").problem
    ph = synthetic.make_scene(**small, dtype=np.float64, device="cpu").problem
    c_card = float(solve(ps, small_cfg)[1].costs[-1])
    c_host = float(solve(ph, small_cfg)[1].costs[-1])
    rel_small = abs(c_card - c_host) / abs(c_host)
    if not rel_small <= COST_RTOL:
        raise AssertionError(f"std small scene: card f32 {c_card} vs host f64 {c_host}")

    # examples/two_view_ba.py's scene and success test (RMSE < 2 x noise).
    noise = 0.5
    tv = synthetic.make_scene(2, 100, noise_px=noise, perturb_rot=0.05, perturb_trans=0.1,
                              perturb_point=0.1, seed=0, dtype=np.float32,
                              device="cuda").problem
    tv_out, tv_st = solve(tv, LMConfig(layout="std", max_iters=30))
    rmse = metrics.reprojection_rmse(tv_out)
    if not rmse < 2.0 * noise:
        raise AssertionError(f"two-view std solve: RMSE {rmse} px, noise {noise} px")

    C, P, cp = p.n_cameras, p.n_points, p.cam_dof
    print(f"[std] solve(layout='std') {N_ITERS} iters, M={p.n_obs}: cost {costs[0]:.6e} -> "
          f"{costs[-1]:.6e}, {launches} projection-kernel launches (std wrapper), accepted "
          f"{int(stats.accepted.sum())}/{N_ITERS}; cm route {c_cm:.6e} (rel {rel:.2e}); small "
          f"scene card f32 vs host f64 rel {rel_small:.2e}; two-view RMSE {rmse:.4f} px "
          f"(< {2 * noise}) in {int(tv_st.n_iters)} iters")
    print(f"[std] ms per LM iteration (best of 3 x {N_ITERS} iters, host clock, synchronized): "
          f"{1e3 * best / N_ITERS:.3f}; dense W operand [P, C*CP, 3] f32 = "
          f"{P * C * cp * 3 * 4 / 1e6:.1f} MB; peak memory allocated {peak / 2**20:.1f} MiB "
          f"| {smi}")

    def kernel():
        return proj.residuals_and_jacobians(p)

    def plain():
        return problem_mod.residuals_and_jacobians(p)

    ms, plain_ms = _device_ms(kernel), _device_ms(plain)
    err, ok = _max_err(kernel(), plain())
    if not ok:
        raise AssertionError(f"std wrapper disagrees with the plain route, max err {err}")
    print(f"[std] projection kernel, std wrapper (kernel + transposes) at M={p.n_obs}: max abs "
          f"err {err:.3e}; device time {ms:.4f} ms, plain {plain_ms:.4f} ms | {smi}")
    return dict(launches=launches, ms=ms, plain_ms=plain_ms)


# --------------------------------------------------------------------------
# The pcg route: six kernels (solver/kernels/spmv.py, csrc/eqs.cu, spmv.cu).
# --------------------------------------------------------------------------


def _bf16_beyond_ulp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Where two bf16 tensors differ by more than one bf16 ulp (8
    significant bits) of the larger."""
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs())
    ulp = torch.where(mag > 0, torch.exp2(torch.floor(torch.log2(mag)) - 7),
                      torch.zeros_like(mag))
    return (a - b).abs() > ulp


def _bf16_ulp_ok(a: torch.Tensor, b: torch.Tensor) -> bool:
    """bf16 tensors equal within one bf16 ulp."""
    return not bool(_bf16_beyond_ulp(a, b).any())


def _eqs_args(p, ops):
    from pysfm_tpu_torch.problem import cm

    args = (ops, cm.cam_table(p), p.X3, p.robust_scale)
    kw = dict(cp=p.cam_dof, model=p.camera_model, robust=p.robust,
              n_cameras=p.n_cameras, n_points=p.n_points)
    return args, kw


def _spmv_inputs(p, ops, eqs, seed=0):
    """Inputs of the three CG-side kernels as the pcg path gives them: the
    coupling rows of the current linearization, a camera vector, a point
    vector and the damped point-block inverses."""
    from pysfm_tpu_torch.solver import scale

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((p.cam_dof, p.n_cameras), generator=g, device="cuda")
    w3 = torch.randn((3, p.n_points), generator=g, device="cuda")
    hinv6 = scale.sym6_inv(scale.augment6(eqs.hpp6, 1e-3)).contiguous()
    return {"hcpT_x": (x,), "hcp_w": (w3, p.n_cameras),
            "precond_diag": (hinv6, p.n_cameras)}


def _spmv_pairs(p, ops, eqs, b_rows, b_cam):
    """{name: (kernel call, plain call)} for the six kernels on p."""
    from pysfm_tpu_torch.solver.kernels import spmv

    args, kw = _eqs_args(p, ops)
    ckw = dict(model=p.camera_model, robust=p.robust)
    dkw = dict(cp=p.cam_dof, **ckw)
    ops_it = ops.replace(b_rows=b_rows, b_cam=b_cam)
    vec = _spmv_inputs(p, ops, eqs)
    pairs = {
        "build_eqs": (lambda: spmv.build_eqs(*args, **kw),
                      lambda: spmv.build_eqs_plain(*args, **kw)),
        "payload_b": (lambda: spmv.payload_b(*args, **dkw),
                      lambda: spmv.payload_b_plain(*args, **dkw)),
        "cost": (lambda: spmv.cost(*args, **ckw), lambda: spmv.cost_plain(*args, **ckw)),
    }
    for name in ("hcpT_x", "hcp_w", "precond_diag"):
        fn, plain = getattr(spmv, name), getattr(spmv, name + "_plain")
        a = vec[name]
        pairs[name] = (lambda fn=fn, a=a: fn(ops_it, *a, cp=p.cam_dof),
                       lambda plain=plain, a=a: plain(ops_it, *a, cp=p.cam_dof))
    return pairs


def _flat(out):
    """A kernel's outputs as a list of tensors (K_E: Hcc, g_c, hpp6, g_p,
    b_rows, b_cam)."""
    if isinstance(out, tuple):
        eqs, b_rows, b_cam = out
        return [eqs.Hcc, eqs.g_c, eqs.hpp6, eqs.g_p, b_rows, b_cam]
    return [out]


def _check_pair(name, kernel, plain, bf16_rows, f32_rows=None):
    """Kernel against plain on the same inputs, and two launches bit for
    bit; returns the worst abs error.  bf16 rows are held to one bf16 ulp
    of the plain version's (the two round their f32 values independently),
    or, given ``f32_rows`` (the same kernel's rows stored in f32 on the same
    inputs, themselves held to the plain version), to those rows rounded to
    bf16 bit for bit."""
    outs, outs2 = _flat(kernel()), _flat(kernel())
    torch.cuda.synchronize()
    refs = _flat(plain())
    for a, a2 in zip(outs, outs2):
        if not torch.equal(a, a2):
            raise AssertionError(f"{name}: two launches differ")
    worst = 0.0
    rows_f32 = iter(f32_rows or ())
    for i, (a, b) in enumerate(zip(outs, refs)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name}[{i}]: {a.shape} {a.dtype} != {b.shape} {b.dtype}")
        if bf16_rows and a.dtype == torch.bfloat16:
            if f32_rows is not None:
                if not torch.equal(a, next(rows_f32).to(torch.bfloat16)):
                    raise AssertionError(f"{name}: bf16 rows are not its f32 rows rounded")
            elif not _bf16_ulp_ok(a, b):
                raise AssertionError(f"{name}: bf16 rows differ by more than one ulp")
            continue
        err, ok = _max_err([a], [b])
        if not ok:
            raise AssertionError(f"{name}[{i}]: kernel disagrees with plain, max err {err}")
        worst = max(worst, err)
    return worst


def _kd_vs_ke(p, ops, b_rows) -> bool:
    """K_D's rows against K_E's ``b_rows`` at the same parameters (within
    KERNEL_TOL, bf16 within one ulp); returns whether they are bitwise
    equal."""
    from pysfm_tpu_torch.solver.kernels import spmv

    args, _ = _eqs_args(p, ops)
    b = spmv.payload_b(*args, cp=p.cam_dof, model=p.camera_model, robust=p.robust)
    if b.dtype == torch.bfloat16:
        ok = _bf16_ulp_ok(b, b_rows)
    else:
        ok = _max_err([b], [b_rows])[1]
    if not ok:
        raise AssertionError("payload_b (K_D) disagrees with build_eqs (K_E) rows")
    return torch.equal(b, b_rows)


def _b_cam_exact(label, ops, b_rows, b_cam) -> None:
    """K_E's camera-sorted rows must be its point-sorted rows permuted, bit
    for bit (the same linearize and row expression in both passes)."""
    if not torch.equal(b_cam, b_rows[:, ops.cam_perm.long()]):
        raise AssertionError(f"{label}: build_eqs b_cam != b_rows[:, cam_perm] bitwise")


def _cost_checks(label, p, ops):
    """K_C against the plain version, two launches bitwise equal, the
    ticket counter back at 0 after every call.  Returns the abs error."""
    from pysfm_tpu_torch.solver.kernels import spmv

    (ops_, ctab, X3, scale), _ = _eqs_args(p, ops)
    ticket = spmv.cost_ticket(X3.device, torch.cuda.current_stream().cuda_stream)
    ref = spmv.cost_plain(ops_, ctab, X3, scale, model=p.camera_model, robust=p.robust)
    outs = []
    for _ in range(2):
        outs.append(spmv.cost(ops_, ctab, X3, scale, model=p.camera_model, robust=p.robust))
        torch.cuda.synchronize()
        if int(ticket.item()) != 0:
            raise AssertionError(f"{label}: cost ticket {int(ticket.item())} after a call")
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError(f"{label}: cost differs between launches")
    err, ok = _max_err(outs[:1], [ref])
    if not ok:
        raise AssertionError(f"{label}: cost {float(outs[0])} vs plain {float(ref)}")
    return err


def _proj_args_cm(p):
    """The projection kernel's operands from a CMProblem (the same
    observations in the std layout's tables)."""
    uv = torch.stack([p.u, p.v], dim=1).contiguous()
    return (p.R, p.t, p.intr, p.X3.T.contiguous(), p.obs_cam, p.obs_pt, uv, p.obs_w,
            p.cam_fixed, p.robust_scale)


def _proj_branches(label, model, robust, args):
    """The projection kernel with 4 observations a thread in vectors and
    with one a thread, on the same operands: each against the plain version
    and two launches of each bitwise equal (the vector branch is refused
    where M % 4 != 0).  The two branches compute each observation with the
    same code, but the compiler may contract other multiply-adds in the two
    instantiations, so they are held to the plain version each and not to
    each other.  Returns (worst abs error, whether the vector branch ran,
    whether the two branches gave the same bits)."""
    from pysfm_tpu_torch.solver.kernels import proj

    ref = proj._plain(model, robust, *args)
    outs, worst = {}, 0.0
    for vec in (True, False):
        try:
            a = proj._launch_cm(model, robust, *args, vec=vec)
        except RuntimeError:
            if vec and args[6].shape[0] % 4:
                continue
            raise
        b = proj._launch_cm(model, robust, *args, vec=vec)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{label}: projection kernel (vec={vec}) differs between "
                                 "launches")
        err, ok = _max_err(a, ref)
        if not ok:
            raise AssertionError(f"{label}: projection kernel (vec={vec}) disagrees with "
                                 f"plain, max err {err}")
        worst = max(worst, err)
        outs[vec] = a
    same = True in outs and all(torch.equal(x, y) for x, y in zip(outs[True], outs[False]))
    return worst, True in outs, same


def _vec_note(runs) -> str:
    """How many scenes ran the projection kernel's vector branch, and in how
    many of those the two branches gave the same bits."""
    ran = [same for vec, same in runs if vec]
    return (f"vector branch on {len(ran)} of {len(runs)} scenes, same bits as one a thread "
            f"in {sum(ran)}")


def _proj_vs_plain_cm(label, p):
    """The projection kernel on a CMProblem's observations, in both branches
    (``_proj_branches``); returns (worst abs error, whether the vector
    branch ran, whether the branches gave the same bits)."""
    return _proj_branches(label, p.camera_model, p.robust, _proj_args_cm(p))


def _kernels_vs_plain(p, ops, f32_rows=None):
    """All six kernels against their plain versions on problem p (K_C also
    by ``_cost_checks``), K_D against K_E, and K_E's b_cam
    against its b_rows; returns ({name: worst abs error}, K_D == K_E
    bitwise).  ``f32_rows`` ({kernel:
    its rows in f32}, for bf16 ``ops``) holds the bf16 rows of K_E and K_D
    to those rounded, as ``_check_pair`` says."""
    from pysfm_tpu_torch.solver.kernels import spmv

    bf16 = ops.rows_dtype == torch.bfloat16
    label = f"C={p.n_cameras} {p.camera_model}/{p.robust}"
    args, kw = _eqs_args(p, ops)
    eqs, b_rows, b_cam = spmv.build_eqs(*args, **kw)
    _b_cam_exact(label, ops, b_rows, b_cam)
    errs = {name: _check_pair(name, kernel, plain, bf16, (f32_rows or {}).get(name))
            for name, (kernel, plain) in _spmv_pairs(p, ops, eqs, b_rows, b_cam).items()}
    errs["cost"] = max(errs["cost"], _cost_checks(label, p, ops))
    return errs, _kd_vs_ke(p, ops, b_rows)


def phase_spmv_small() -> None:
    from pysfm_tpu_torch.pipeline import synthetic
    from pysfm_tpu_torch.solver.kernels import spmv
    from pysfm_tpu_torch.solver.lm import make_grouped_ops

    worst = dict.fromkeys(SPMV_KERNELS, 0.0)
    shapes = set()
    kd_bitwise = []
    proj_worst, proj_vec = 0.0, []
    for model in ("pose", "pose_k", "bal"):
        for robust in ("gaussian", "huber", "cauchy"):
            scenes = [(5, 101)] + ([(160, 700)] if robust == "huber" else [])
            for C, P in scenes:
                p = synthetic.make_bal_scene(
                    C, P, mean_track=4.0, max_track=6, camera_model=model,
                    robust=robust, robust_scale=2.0, noise_px=1.0, outlier_frac=0.1,
                    seed=3, dtype=np.float32, with_truth=False, layout="cm",
                ).problem
                shapes.add((C, P, p.n_obs))
                err, vec, same = _proj_vs_plain_cm(f"C={C} {model}/{robust}", p)
                proj_worst = max(proj_worst, err)
                proj_vec.append((vec, same))
                for rows in (torch.float32, torch.bfloat16):
                    errs, same = _kernels_vs_plain(p, make_grouped_ops(p, rows_dtype=rows))
                    worst = {k: max(worst[k], errs[k]) for k in worst}
                    kd_bitwise.append(same)
    p64 = synthetic.make_bal_scene(5, 101, seed=3, dtype=np.float64, with_truth=False,
                                   layout="cm").problem
    ops64 = make_grouped_ops(p64)
    args, kw = _eqs_args(p64, ops64)
    refused = 0
    for call in (lambda: spmv.build_eqs(*args, **kw),
                 lambda: spmv.payload_b(*args, cp=p64.cam_dof, model=p64.camera_model,
                                        robust=p64.robust),
                 lambda: spmv.cost(*args, model=p64.camera_model, robust=p64.robust),
                 lambda: spmv.hcpT_x(ops64.replace(b_rows=torch.zeros(
                     (3 * p64.cam_dof, p64.n_obs), dtype=torch.float64, device="cuda")),
                     torch.zeros((p64.cam_dof, p64.n_cameras), dtype=torch.float64,
                                 device="cuda"), cp=p64.cam_dof)):
        try:
            call()
        except TypeError:
            refused += 1
    if refused != 4:
        raise AssertionError("a pcg kernel wrapper accepted f64 CUDA tensors")
    # hcp_w's and K_H's kernels read only the camera-sorted rows: without
    # them they raise.
    ops32 = make_grouped_ops(p)
    args, kw = _eqs_args(p, ops32)
    _, b_rows, _ = spmv.build_eqs(*args, **kw)
    no_b_cam = ops32.replace(b_rows=b_rows)
    for name, call in (
            ("hcp_w", lambda: spmv.hcp_w(no_b_cam, torch.zeros((3, p.n_points), device="cuda"),
                                         p.n_cameras, cp=p.cam_dof)),
            ("precond_diag", lambda: spmv.precond_diag(
                no_b_cam, torch.zeros((6, p.n_points), device="cuda"), p.n_cameras,
                cp=p.cam_dof))):
        try:
            call()
        except ValueError:
            pass
        else:
            raise AssertionError(f"{name} ran on CUDA GroupedOps without b_cam")
    print(f"[spmv kernels] 3 models x 3 robust kernels, f32 and bf16 rows, scenes (C, P, M) "
          f"{sorted(shapes)}: kernel == plain, max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" (bound {KERNEL_TOL} x (max|ref|+1); bf16 rows within one ulp); two launches "
          f"bitwise equal; cost's ticket back at 0 after every call; projection kernel on "
          f"the same scenes == plain, max abs err {proj_worst:.3e} ({_vec_note(proj_vec)}); "
          f"f64 refused; hcp_w and precond_diag without b_cam refused; "
          f"build_eqs b_cam == b_rows[:, cam_perm] bitwise in all {len(kd_bitwise)} cases; "
          f"payload_b (K_D) == "
          f"build_eqs (K_E) rows within bound, bitwise equal in {sum(kd_bitwise)} of "
          f"{len(kd_bitwise)} cases")
    phase_spmv_edges()


def _random_hinv6(P, g):
    """Packed lower triangles (00, 10, 11, 20, 21, 22) of P random SPD 3x3
    matrices A A^T + 0.1 I."""
    A = torch.randn((P, 3, 3), generator=g, device="cuda")
    H = A @ A.transpose(1, 2) + 0.1 * torch.eye(3, device="cuda")
    return torch.stack([H[:, 0, 0], H[:, 1, 0], H[:, 1, 1], H[:, 2, 0], H[:, 2, 1],
                        H[:, 2, 2]]).contiguous()


def phase_spmv_edges() -> None:
    """The kernels on the edge shapes of the plans (synthetic.PLAN_EDGES),
    CP 6 / 9 / 10, f32 and bf16 rows, each against its plain version with
    two launches bitwise equal: hcpT_x, hcp_w and K_H on random rows (K_H
    with random SPD point blocks; an empty camera's D exactly 0), and K_E
    (with every other pcg kernel, K_D against K_E's rows and b_cam bitwise
    b_rows[:, cam_perm]) on a scene built on the same observations.
    hcpT_x runs as the path calls it (x placed by size) and in each branch,
    x in shared memory and x from global memory, which must agree bit for
    bit; x in shared memory must be refused where it does not fit."""
    from pysfm_tpu_torch.pipeline import synthetic
    from pysfm_tpu_torch.solver.kernels import spmv
    from pysfm_tpu_torch.solver.lm import make_grouped_ops

    worst = {"hcpT_x": 0.0, "hcp_w": 0.0, "precond_diag": 0.0}
    shapes, refused = [], set()
    for kind in synthetic.PLAN_EDGES:
        obs_cam, obs_pt, C, P = synthetic.plan_edge_incidence(kind)
        M = obs_cam.shape[0]
        dev_ids = [torch.from_numpy(a).to("cuda") for a in (obs_cam, obs_pt)]
        z = torch.zeros(M, device="cuda")
        ops = spmv.grouped_ops(*dev_ids, C, P, z, z, z, torch.float32)
        track = torch.diff(ops.pt_ptr)
        shapes.append((kind, C, P, M, int(track.max()),
                       int(torch.diff(ops.cam_ptr).max()), int((torch.diff(ops.cam_ptr) == 0).sum())))
        g = torch.Generator(device="cuda").manual_seed(len(shapes))
        hinv6 = _random_hinv6(P, g)
        empty = torch.diff(ops.cam_ptr) == 0
        for cp in (6, 9, 10):
            b32 = torch.randn((3 * cp, M), generator=g, device="cuda")
            x = torch.randn((cp, C), generator=g, device="cuda")
            w3 = torch.randn((3, P), generator=g, device="cuda")
            for rows in (torch.float32, torch.bfloat16):
                b = b32.to(rows)
                it = ops.replace(rows_dtype=rows, b_rows=b, b_cam=b[:, ops.cam_perm.long()])
                checks = [
                    ("hcpT_x", lambda: spmv.hcpT_x(it, x, cp=cp),
                     lambda: spmv.hcpT_x_plain(it, x, cp=cp)),
                    ("hcpT_x (x from global memory)",
                     lambda: spmv._launch_hcpT_x(it, x, cp, False),
                     lambda: spmv.hcpT_x_plain(it, x, cp=cp)),
                    ("hcp_w", lambda: spmv.hcp_w(it, w3, C, cp=cp),
                     lambda: spmv.hcp_w_plain(it, w3, C, cp=cp)),
                    ("precond_diag", lambda: spmv.precond_diag(it, hinv6, C, cp=cp),
                     lambda: spmv.precond_diag_plain(it, hinv6, C, cp=cp))]
                if bool(spmv.precond_diag(it, hinv6, C, cp=cp)[empty].any()):
                    raise AssertionError(f"precond_diag ({kind}, CP={cp}): an empty camera's "
                                         "D is not 0")
                try:
                    shared = spmv._launch_hcpT_x(it, x, cp, True)
                except RuntimeError:
                    refused.add((kind, cp))
                else:
                    if not torch.equal(shared, spmv._launch_hcpT_x(it, x, cp, False)):
                        raise AssertionError(f"hcpT_x ({kind}, CP={cp}): the two branches differ")
                    checks.append(("hcpT_x (x in shared memory)",
                                   lambda: spmv._launch_hcpT_x(it, x, cp, True),
                                   lambda: spmv.hcpT_x_plain(it, x, cp=cp)))
                for name, kernel, plain in checks:
                    err = _check_pair(f"{name} ({kind}, CP={cp}, {rows})", kernel, plain, False)
                    key = name.split()[0]
                    worst[key] = max(worst[key], err)
    # K_E (and the rest) on a scene on the same observations, one camera
    # model for each CP.  The bf16 rows of K_E and K_D are held bit for bit
    # to their f32 rows rounded (those within KERNEL_TOL of the plain
    # version): an entry where the row's two products nearly cancel differs
    # from the plain f32 value by more than a bf16 ulp of itself while
    # inside the f32 bound; such entries are counted.
    eqs_worst = dict.fromkeys(SPMV_KERNELS, 0.0)
    kd_bitwise, beyond_ulp, n_rows = [], 0, 0
    proj_worst, proj_vec = 0.0, []
    for kind in synthetic.PLAN_EDGES:
        for model in ("pose", "bal", "pose_k"):
            p = synthetic.plan_edge_scene(kind, camera_model=model, device="cuda")
            err, vec, same = _proj_vs_plain_cm(f"{kind} {model}", p)
            proj_worst = max(proj_worst, err)
            proj_vec.append((vec, same))
            ops32 = make_grouped_ops(p)
            errs, same = _kernels_vs_plain(p, ops32)
            eqs_worst = {k: max(eqs_worst[k], errs[k]) for k in eqs_worst}
            kd_bitwise.append(same)
            args, kw = _eqs_args(p, ops32)
            _, r32, c32 = spmv.build_eqs(*args, **kw)
            k32 = spmv.payload_b(*args, cp=p.cam_dof, model=model, robust=p.robust)
            ops16 = make_grouped_ops(p, rows_dtype=torch.bfloat16)
            errs, same = _kernels_vs_plain(
                p, ops16, {"build_eqs": [r32, c32], "payload_b": [k32]})
            eqs_worst = {k: max(eqs_worst[k], errs[k]) for k in eqs_worst}
            kd_bitwise.append(same)
            args16, _ = _eqs_args(p, ops16)
            _, r16, _ = spmv.build_eqs(*args16, **kw)
            _, p16, _ = spmv.build_eqs_plain(*args16, **kw)
            beyond_ulp += int(_bf16_beyond_ulp(r16, p16).sum())
            n_rows += r16.numel()
    print("[spmv kernels] edge shapes (kind, C, P, M, longest track, most observations of a "
          f"camera, cameras without observations) {shapes}, CP 6/9/10, f32 and bf16 rows: "
          f"kernel == plain on random rows, max abs err hcpT_x {worst['hcpT_x']:.3e} (both "
          f"branches), hcp_w {worst['hcp_w']:.3e}, precond_diag {worst['precond_diag']:.3e} "
          f"(random SPD Hinv; empty cameras' D exactly 0); two launches bitwise equal; hcpT_x "
          f"with x in shared memory == x from global memory bitwise, refused at (kind, CP) "
          f"{sorted(refused)} (chunk {spmv.HCP_W_CHUNK}, tile {spmv.HCPT_X_TILE})")
    print("[spmv kernels] edge scenes (plan_edge_scene: the same observations, models pose / "
          "bal / pose_k, Huber), f32 and bf16 rows: kernel == plain, max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in eqs_worst.items())
          + f" (cost's ticket back at 0); projection kernel on the same "
          f"observations == plain, max abs err {proj_worst:.3e} ({_vec_note(proj_vec)})"
          + f"; bf16 rows of K_E and K_D == their f32 rows rounded, bitwise; K_E bf16 row "
          f"entries beyond one ulp of the plain version's: {beyond_ulp} of {n_rows}; build_eqs "
          f"b_cam == b_rows[:, cam_perm] bitwise in all {len(kd_bitwise)} cases; payload_b (K_D) "
          f"== build_eqs (K_E) rows within bound, bitwise equal in {sum(kd_bitwise)} of "
          f"{len(kd_bitwise)}")
    # 6000 cameras x CP 10 x 4 B = 240 KB of x: over the H100's 227 KB a block.
    if refused != {("x_too_large_for_shared_memory", 10)}:
        raise AssertionError(f"hcpT_x refused x in shared memory at {sorted(refused)}")


def _spmv_cost(name, p, ops, b_rows):
    """(bytes moved, f32 operations) of one call on problem p: each input
    read once, each output written once."""
    C, P, M, cp = p.n_cameras, p.n_points, p.n_obs, p.cam_dof
    rb = b_rows.element_size() * 3 * cp * M
    ntri = cp * (cp + 1) // 2
    if name == "build_eqs":
        # The function's bytes: one copy of the rows (the camera-sorted copy
        # is this port's layout for hcp_w; chip_smoke prints its cost apart).
        nbytes = (4 * ((13 + p.intr.shape[1]) * C + 3 * P + 6 * M + P + C + 3)
                  + rb + 4 * (C * cp * cp + C * cp + 9 * P))
        ops = M * (LINEARIZE_OPS + 4 * 3 * cp + 5 * (ntri + cp) + 5 * 9)
    elif name == "payload_b":
        # Tables, 20 B an observation (two ids, u, v, w), the rows.
        nbytes = 4 * ((13 + p.intr.shape[1]) * C + 3 * P + 5 * M + 1) + rb
        ops = M * (LINEARIZE_OPS + 4 * 3 * cp)
    elif name == "cost":
        nbytes = 4 * ((13 + p.intr.shape[1]) * C + 3 * P + 5 * M + 2)
        ops = M * 40
    elif name == "hcpT_x":
        nbytes = rb + 4 * (cp * C + M + P + 1 + 3 * P)
        ops = M * 2 * 3 * cp
    elif name == "hcp_w":
        nbytes = rb + 4 * (3 * P + 2 * M + C + 1 + cp * C)
        ops = M * 2 * 3 * cp
    else:
        # K_H: one copy of the rows, each observation's point (cam_pt),
        # hinv6 once and D.
        nbytes = rb + 4 * (M + 6 * P + C * cp * cp)
        ops = M * (5 * 3 * cp + 6 * ntri)
    return nbytes, ops


def _sparse_hcp(p, ops, b_rows):
    """CSR tensors of Hcp [C*CP, 3P] and Hcp^T from the coupling rows: the
    yardstick library call (torch.sparse) for the two products.  The port
    never calls it."""
    C, P, M, cp = p.n_cameras, p.n_points, p.n_obs, p.cam_dof
    s = torch.arange(3, device="cuda").view(3, 1, 1)
    d = torch.arange(cp, device="cuda").view(1, cp, 1)
    rows = (ops.obs_cam.long().view(1, 1, M) * cp + d).expand(3, cp, M).reshape(-1)
    cols = (ops.obs_pt.long().view(1, 1, M) * 3 + s).expand(3, cp, M).reshape(-1)
    vals = b_rows.float().reshape(-1)
    with warnings.catch_warnings():  # torch's notes that sparse CSR is beta
        warnings.simplefilter("ignore", UserWarning)
        hcp = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (C * cp, 3 * P))
        hcpT = torch.sparse_coo_tensor(torch.stack([cols, rows]), vals, (3 * P, C * cp))
        return hcp.coalesce().to_sparse_csr(), hcpT.coalesce().to_sparse_csr()


def phase_spmv_timing(p, ops, label, smi, n=20) -> dict:
    """Every kernel against its plain version at this shape, then its device
    time, the plain version's, the bound and (for the two products) the
    torch.sparse call's; returns {name: stats}."""
    from pysfm_tpu_torch.solver.kernels import spmv

    args, kw = _eqs_args(p, ops)
    eqs, b_rows, b_cam = spmv.build_eqs(*args, **kw)
    _b_cam_exact(label, ops, b_rows, b_cam)
    pairs = _spmv_pairs(p, ops, eqs, b_rows, b_cam)
    kd_same = _kd_vs_ke(p, ops, b_rows)
    print(f"[{label}] build_eqs b_cam == b_rows[:, cam_perm] bitwise at M={p.n_obs}; "
          f"payload_b (K_D) == build_eqs (K_E) rows: within bound, bitwise equal {kd_same}; "
          f"the b_cam store alone: {b_cam.numel() * b_cam.element_size() / 1e6:.1f} MB, "
          f"bound {_bound(b_cam.numel() * b_cam.element_size(), 0)[0]:.4f} ms")
    hcp, hcpT = _sparse_hcp(p, ops, b_rows)
    vec = _spmv_inputs(p, ops, eqs)
    x_flat = vec["hcpT_x"][0].T.reshape(-1, 1).contiguous()       # (c*CP + d)
    w_flat = vec["hcp_w"][0].T.reshape(-1, 1).contiguous()        # (p*3 + s)
    library = {"hcpT_x": lambda: torch.sparse.mm(hcpT, x_flat),
               "hcp_w": lambda: torch.sparse.mm(hcp, w_flat)}
    # The library call computes the same function: check it before timing.
    u = pairs["hcpT_x"][0]()
    y = pairs["hcp_w"][0]()
    _, ok_u = _max_err([library["hcpT_x"]().reshape(-1, 3).T], [u])
    _, ok_y = _max_err([library["hcp_w"]().reshape(-1, p.cam_dof).T], [y])
    if not (ok_u and ok_y):
        raise AssertionError(f"{label}: torch.sparse yardstick disagrees with the kernels")
    # hcpT_x's two branches at this shape: x in shared memory (as the path
    # runs it where x fits) against x gathered from global memory.
    x = vec["hcpT_x"][0]
    ops_it = ops.replace(b_rows=b_rows, b_cam=b_cam)
    if not torch.equal(spmv._launch_hcpT_x(ops_it, x, p.cam_dof, True),
                       spmv._launch_hcpT_x(ops_it, x, p.cam_dof, False)):
        raise AssertionError(f"{label}: hcpT_x's two branches differ")
    ms_x = [_device_ms(lambda sh=sh: spmv._launch_hcpT_x(ops_it, x, p.cam_dof, sh), n)
            for sh in (True, False, True, False)]
    print(f"[{label}] hcpT_x device time, x in shared memory {ms_x[0]:.4f}, {ms_x[2]:.4f} ms; "
          f"x from global memory {ms_x[1]:.4f}, {ms_x[3]:.4f} ms | {smi}")
    # K_C at this shape: two launches bitwise equal, the ticket back at 0.
    cost_err = _cost_checks(label, p, ops)
    floor_ms = _device_ms(noop_call(), n)
    print(f"[{label}] cost: two launches bitwise equal, ticket back at 0, max abs err "
          f"{cost_err:.3e}; empty-kernel floor {floor_ms:.4f} ms | {smi}")
    out = {}
    for name, (kernel, plain) in pairs.items():
        err = _check_pair(name, kernel, plain, False)
        ms, plain_ms = _device_ms(kernel, n), _device_ms(plain, n)
        lib_ms = _device_ms(library[name], n) if name in library else None
        bound_ms, bound_by = _bound(*_spmv_cost(name, p, ops, b_rows))
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=lib_ms, floor_ms=floor_ms)
        lib = "" if lib_ms is None else f", torch.sparse {lib_ms:.4f} ms"
        print(f"[{label}] {name} at C={p.n_cameras} P={p.n_points} M={p.n_obs}: max abs err "
              f"{err:.3e}; device time kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}; "
              f"bound {bound_ms:.4f} ms ({bound_by}), floor {floor_ms:.4f} ms | {smi}")
    return out


def _expected_launches(st, cfg, seg=None) -> dict:
    """Each kernel's launches implied by the LM and CG logs of one pcg solve
    (block-Jacobi preconditioner, CG warm start, linearization reuse), or of
    a ``solve_segmented`` run of ``seg`` iterations a segment."""
    n = int(st.n_iters)
    acc = st.accepted[:n].cpu().numpy()
    cg = st.cg_iters[:n].cpu().numpy().astype(int)
    if cfg.cg_precond_terms != 1 or not cfg.cg_warm_start or not cfg.reuse_linearization:
        raise ValueError("the launch formula below assumes the default pcg options")
    segs = [acc[i:i + (seg or n)] for i in range(0, n, seg or n)]
    return {
        # Each solve: first build + one after each accept but its last.
        "build_eqs": sum(1 + int(a[:-1].sum()) for a in segs),
        "payload_b": 0,                         # on no solve path
        "cost": sum(1 + len(a) for a in segs),  # initial cost + each candidate
        "precond_diag": n,                      # one system build per iteration
        # rhs, warm-start residual, one per CG iteration:
        "hcp_w": int((2 + cg).sum()),
        # warm-start residual, one per CG iteration, back-substitution:
        "hcpT_x": int((2 + cg).sum()),
    }


def _check_counts(label, cfg, st, seg=None) -> dict:
    """The spmv counts since the last reset against the LM/CG logs."""
    from pysfm_tpu_torch.solver.kernels import proj, spmv

    counts = dict(spmv.LAUNCHES)
    expected = _expected_launches(st, cfg, seg)
    if counts != expected or proj.LAUNCHES:
        raise AssertionError(f"{label}: launches {counts} (proj {proj.LAUNCHES}), "
                             f"expected {expected} from the LM/CG logs")
    return counts


def _pcg_solve_counted(p, cfg, gops, label):
    """Drive the pcg path with the counts set to 0 just before and read just
    after; check them against the logs.  Returns (stats, seconds, counts)."""
    _reset_counts()
    _, st, secs = _solve_timed(p, cfg, gops)
    counts = _check_counts(label, cfg, st)
    costs = st.costs.cpu().numpy()
    if not np.all(np.isfinite(costs)) or not costs[-1] < costs[0]:
        raise AssertionError(f"{label}: bad cost log {costs}")
    return st, secs, counts


def _traced(fn):
    """fn() once under torch.profiler: (its result, its wall seconds, the
    trace's device events, their device busy time in ms).  Profiling slows
    the host, so the traced wall is longer than an untraced run's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out, secs = _timed(fn)
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return out, secs, dev, sum(e.self_device_time_total for e in dev) / 1e3


def _top_device(dev, n=6) -> str:
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:n]
    return "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} ms x{e.count}"
                     for e in top)


def phase_profile(p, cfg, gops, label, smi) -> None:
    """One pcg solve under torch.profiler: device busy time over the traced
    wall (the idle share), device kernels per LM iteration, and the kernels
    that take the most device time."""
    _solve_timed(p, cfg, gops)  # warm-up
    (_, st, _), secs, dev, busy_ms = _traced(lambda: _solve_timed(p, cfg, gops))
    n = int(st.n_iters)
    if busy_ms <= 0.0:
        print(f"[{label} profile] the trace holds no device time: idle share not measured")
        return
    print(f"[{label} profile] {n} LM iterations traced in {1e3 * secs:.1f} ms: device busy "
          f"{busy_ms:.1f} ms, idle share {1 - busy_ms / (1e3 * secs):.3f}; "
          f"{sum(e.count for e in dev) / n:.1f} device kernels per LM iteration; most "
          "device time: " + _top_device(dev) + f" | {smi}")


def phase_pcg_main(smi) -> dict:
    from pysfm_tpu_torch.pipeline import synthetic
    from pysfm_tpu_torch.problem import cm
    from pysfm_tpu_torch.solver import LMConfig, solve
    from pysfm_tpu_torch.solver.lm import make_grouped_ops

    p = cm.from_problem(synthetic.make_scene(**MAIN_SCENE, device="cuda").problem)
    gops = make_grouped_ops(p)
    cfg = LMConfig(max_iters=N_ITERS, **NO_TOL, **PCG_MAIN)
    st, secs, counts = _pcg_solve_counted(p, cfg, gops, "pcg main")
    n = int(st.n_iters)
    costs = st.costs.cpu().numpy()
    _, st_plain, secs_plain = _solve_timed(p, cfg)
    c_plain = float(st_plain.costs[-1])
    rel = abs(costs[-1] - c_plain) / abs(c_plain)
    if not rel <= COST_RTOL:
        raise AssertionError(f"pcg kernel route final cost {costs[-1]} vs plain {c_plain}")
    # Best of 3, alternating routes (plain, kernel, kernel, plain, ...).
    best = {"kernel": secs, "plain": secs_plain}
    for order in (("kernel", "plain"), ("plain", "kernel"), ("kernel", "plain")):
        for route in order:
            _, _, t = _solve_timed(p, cfg, gops if route == "kernel" else None)
            best[route] = min(best[route], t)

    small = dict(n_cameras=6, n_points=300, noise_px=0.5, outlier_frac=0.05,
                 outlier_px=40.0, robust="huber", robust_scale=2.0, seed=11)
    small_cfg = LMConfig(max_iters=10, **NO_TOL, **PCG_MAIN)
    ps = cm.from_problem(synthetic.make_scene(**small, dtype=np.float32, device="cuda").problem)
    ph = cm.from_problem(synthetic.make_scene(**small, dtype=np.float64, device="cpu").problem)
    c_card = float(solve(ps, small_cfg, gops=make_grouped_ops(ps))[1].costs[-1])
    c_host = float(solve(ph, small_cfg)[1].costs[-1])
    rel_small = abs(c_card - c_host) / abs(c_host)
    if not rel_small <= COST_RTOL:
        raise AssertionError(f"pcg small scene: card f32 {c_card} vs host f64 {c_host}")
    cg = st.cg_iters[:n].cpu().numpy()
    syncs = n + int(cg.sum()) + int((cg < cfg.cg_iters).sum())
    print(f"[pcg main] solve(CMProblem, pcg/ew, gops) {n} iters, C={p.n_cameras} "
          f"P={p.n_points} M={p.n_obs}: cost {costs[0]:.6e} -> {costs[-1]:.6e}, accepted "
          f"{int(st.accepted.sum())}/{n}, CG iterations {cg.tolist()} (sum {int(cg.sum())}); "
          f"launches {counts} == LM/CG logs; plain route {c_plain:.6e} (rel {rel:.2e}); "
          f"small scene card f32 vs host f64 rel {rel_small:.2e}")
    print(f"[pcg main] ms per LM iteration (best of 4 x {n} iters, host clock, synchronized): "
          f"kernel route {1e3 * best['kernel'] / n:.3f}, plain route "
          f"{1e3 * best['plain'] / n:.3f}; host syncs in the counted run {syncs} (one per LM "
          f"iteration, one per CG iteration, one per CG exit before cg_iters) | {smi}")
    phase_profile(p, cfg, gops, "pcg main", smi)
    stats = phase_spmv_timing(p, gops, "pcg main", smi)
    for name in SPMV_KERNELS:
        print(f"[pcg main] {name}: {counts[name] / n:.2f} launches per LM iteration")
    return stats, counts


def phase_pcg_venice(smi) -> dict:
    from pysfm_tpu_torch.pipeline import synthetic
    from pysfm_tpu_torch.solver import LMConfig
    from pysfm_tpu_torch.solver.lm import make_grouped_ops

    t0 = time.perf_counter()
    p = synthetic.make_bal_scene(**VENICE_SCENE, device="cuda").problem
    torch.cuda.synchronize()
    t_scene = time.perf_counter() - t0
    t0 = time.perf_counter()
    gops = make_grouped_ops(p)
    torch.cuda.synchronize()
    t_layout = time.perf_counter() - t0
    print(f"[pcg venice] scene C={p.n_cameras} P={p.n_points} M={p.n_obs} built in "
          f"{t_scene:.3f} s, kernel layout (make_grouped_ops) in {t_layout:.3f} s")
    stats = phase_spmv_timing(p, gops, "pcg venice", smi, n=10)
    cfg = LMConfig(max_iters=VENICE_ITERS, **NO_TOL, **PCG_VENICE)
    torch.cuda.reset_peak_memory_stats()
    st, secs, counts = _pcg_solve_counted(p, cfg, gops, "pcg venice")
    n = int(st.n_iters)
    print(f"[pcg venice] {n} LM iterations: {1e3 * secs / n:.1f} ms per LM iteration "
          f"(host clock, synchronized); "
          f"cost curve {[float(f'{c:.6e}') for c in st.costs.cpu().numpy()]}; CG iterations "
          f"{st.cg_iters.cpu().numpy().tolist()}; accepted {int(st.accepted.sum())}/{n}; "
          f"launches {counts} == LM/CG logs; max memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {smi}")
    for name in SPMV_KERNELS:
        print(f"[pcg venice] {name}: {counts[name] / n:.2f} launches per LM iteration")
    phase_profile(p, cfg, gops, "pcg venice", smi)
    return stats, counts, (p, st, secs)


def phase_proj_venice(smi) -> dict:
    """The projection kernel at the Venice scene's M (the std layout of the
    Venice-scale scene; no dense route solves at that size): against its
    plain version, two launches bitwise equal, then its device time, the
    plain version's, the bound and the floor."""
    from pysfm_tpu_torch.pipeline import synthetic
    from pysfm_tpu_torch.solver.kernels import proj

    p = synthetic.make_bal_scene(**{**VENICE_SCENE, "layout": "std"}, device="cuda").problem
    args = proj._problem_args(p)
    err, vec, same = _proj_branches("proj venice", p.camera_model, p.robust, args)
    if not vec:
        raise AssertionError(f"proj venice M={p.n_obs}: the vector branch did not run")
    ms_v = [_device_ms(lambda v=v: proj._launch_cm(p.camera_model, p.robust, *args, vec=v), 10)
            for v in (True, False, True, False)]
    print(f"[proj venice] 4 observations a thread in vectors {ms_v[0]:.4f}, {ms_v[2]:.4f} ms; "
          f"one a thread {ms_v[1]:.4f}, {ms_v[3]:.4f} ms (each within bound of plain; same "
          f"bits: {same}) | {smi}")

    def kernel():
        return proj.residuals_and_jacobians_cm(p)

    def plain():
        return proj._plain(p.camera_model, p.robust, *args)

    floor_ms = _device_ms(noop_call(), 10)
    ms, plain_ms = _device_ms(kernel, 10), _device_ms(plain, 10)
    bound_ms, bound_by = _bound(*_proj_cost(p))
    print(f"[proj venice] projection kernel at C={p.n_cameras} P={p.n_points} M={p.n_obs} "
          f"(std layout, outputs {4 * (2 + 2 * p.cam_dof + 6 + 1) * p.n_obs / 1e6:.0f} MB): "
          f"max abs err {err:.3e}; device time kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(median of 10); bound {bound_ms:.4f} ms ({bound_by}), floor {floor_ms:.4f} ms "
          f"| {smi}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, floor_ms=floor_ms)


def phase_bal_io(smi) -> dict:
    """bench/io_scale.py on the port: BAL text file -> native tokenizer ->
    CMProblem on the card -> segmented pcg solve with the kernels -> CM
    checkpoint at the half -> resume; returns the straight solve's counts."""
    import shutil
    import tempfile

    from pysfm_tpu_torch.io import load_bal, load_checkpoint_cm, native, save_bal
    from pysfm_tpu_torch.io import save_checkpoint_cm
    from pysfm_tpu_torch.pipeline import synthetic
    from pysfm_tpu_torch.solver import LMConfig, solve
    from pysfm_tpu_torch.solver.lm import make_grouped_ops, solve_segmented

    sp = synthetic.make_bal_scene(**IO_SCENE, device="cuda").problem
    tmp = tempfile.mkdtemp(prefix="pysfm_io_")
    try:
        path = os.path.join(tmp, "scene.bal")
        _, t_save = _timed(lambda: save_bal(path, sp))
        mb = os.path.getsize(path) / 1e6
        cmp, t_load = _timed(lambda: load_bal(path, layout="cm", dtype=np.float32,
                                              robust="huber", robust_scale=2.0))
        if not native.have_native():
            raise AssertionError("bal io: the native tokenizer did not load")
        if not (torch.equal(cmp.obs_cam, sp.obs_cam) and torch.equal(cmp.obs_pt, sp.obs_pt)):
            raise AssertionError("bal io: loaded observation ids differ from the saved ones")
        if not torch.allclose(cmp.X3, sp.X.T, rtol=1e-6, atol=1e-7):
            raise AssertionError("bal io: loaded points differ from the saved ones")
        gops, t_gops = _timed(lambda: make_grouped_ops(cmp))
        cfg = LMConfig(max_iters=IO_ITERS, solver="pcg", cg_iters=25, cg_tol=1e-2, **NO_TOL)
        _reset_counts()
        (_, st_full), t_solve = _timed(
            lambda: solve_segmented(cmp, cfg, iters_per_dispatch=6, gops=gops))
        counts = _check_counts("bal io", cfg, st_full, seg=6)

        half = IO_ITERS // 2
        cfg_half = dataclasses.replace(cfg, max_iters=half)
        p_half, st_half = solve_segmented(cmp, cfg_half, iters_per_dispatch=6, gops=gops)
        ck = os.path.join(tmp, "ckpt.npz")
        _, t_ck = _timed(lambda: save_checkpoint_cm(
            ck, p_half, lam=float(st_half.lam_next), nu=float(st_half.nu_next),
            iteration=half))
        (cmp_r, lam_r, nu_r, it_r), t_restore = _timed(lambda: load_checkpoint_cm(ck))
        if it_r != half or not torch.equal(cmp_r.X3, p_half.X3):
            raise AssertionError("bal io: the checkpoint did not restore the saved state")
        gops_r = make_grouped_ops(cmp_r)
        _reset_counts()
        _, st_res = solve(cmp_r, cfg_half, lam_init=lam_r, nu_init=nu_r, gops=gops_r)
        _check_counts("bal io resume", cfg_half, st_res)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    c_full = st_full.costs.cpu().numpy().astype(np.float64)
    c_res = st_res.costs.cpu().numpy().astype(np.float64)
    tail = c_full[half + 1:]
    rel = float(np.max(np.abs(c_res[1:1 + len(tail)] - tail) / tail))
    if not (np.all(np.isfinite(c_full)) and c_full[-1] < c_full[0]):
        raise AssertionError(f"bal io: bad cost log {c_full}")
    if not rel < RESUME_RTOL:
        raise AssertionError(f"bal io: resumed tail differs by {rel} (gate {RESUME_RTOL})")
    n = int(st_full.n_iters)
    print(f"[bal io] C={cmp.n_cameras} P={cmp.n_points} M={cmp.n_obs} (camera model "
          f"{cmp.camera_model}), BAL file {mb:.1f} MB, native tokenizer loaded: "
          f"{native.have_native()}; ids exact, X3 within 1e-6; cost {c_full[0]:.6e} -> "
          f"{c_full[-1]:.6e} in {n} iters ({int(st_full.accepted.sum())} accepted, CG "
          f"{st_full.cg_iters.cpu().numpy().tolist()}); resumed tail rel {rel:.3e} "
          f"(gate {RESUME_RTOL}); launches {counts} == LM/CG logs")
    print(f"[bal io] seconds: save_bal {t_save:.3f}, load_bal (cm, onto the card) "
          f"{t_load:.3f}, make_grouped_ops {t_gops:.3f}, solve_segmented ({n} iters) "
          f"{t_solve:.3f}, save_checkpoint_cm {t_ck:.3f}, load_checkpoint_cm "
          f"{t_restore:.3f} | {smi}")
    return counts


# The distributed path: the world of one rank over NCCL in this process
# ([dist venice]), and two ranks on the one card over gloo ([dist ranks];
# NCCL refuses two ranks on one device).
DIST_TIMEOUT = 600
# The [bal io] scene in the cm layout, for two ranks of ~313k observations.
DIST_SCENE = {**IO_SCENE, "layout": "cm"}
DIST_CFG = dict(max_iters=IO_ITERS, solver="pcg", cg_iters=25, cg_tol=1e-2, **NO_TOL)
DIST_RTOL_F32 = 1e-3
DIST_RTOL_F64 = 1e-9
DIST_RTOL_VENICE = 1e-6


def _collectives_note(n_lm, n_cg) -> str:
    from pysfm_tpu_torch.utils import collectives

    calls, nbytes = collectives.CALLS, collectives.BYTES
    return (f"collectives {dict(calls)} ({sum(calls.values()) / n_lm:.1f} a LM iteration, "
            f"{sum(calls.values()) / max(n_lm + n_cg, 1):.2f} a LM or CG iteration); payload "
            f"bytes {dict(nbytes)} ({sum(nbytes.values()) / n_lm / 1e3:.1f} kB a LM iteration)")


def _same_log(label, st, ref, rtol):
    """The cost log and CG counts of st against ref's: bitwise, or within
    rtol with equal CG counts; returns a note saying which."""
    c, c_ref = st.costs.cpu().numpy(), ref.costs.cpu().numpy()
    cg, cg_ref = st.cg_iters.cpu().numpy(), ref.cg_iters.cpu().numpy()
    if np.array_equal(c, c_ref) and np.array_equal(cg, cg_ref):
        return "bitwise equal"
    rel = float(np.max(np.abs(c.astype(np.float64) - c_ref) / np.abs(c_ref)))
    if not (rel <= rtol and np.array_equal(cg, cg_ref)):
        raise AssertionError(f"{label}: costs {c.tolist()} vs {c_ref.tolist()} (rel {rel:.3e}, "
                             f"gate {rtol}), CG {cg.tolist()} vs {cg_ref.tolist()}")
    return f"not bitwise: max rel {rel:.3e} (gate {rtol}), CG counts equal"


def phase_dist_venice(smi, venice, main_costs) -> dict:
    """The distributed pcg route (solve_sharded_cm with the kernels) on the
    Venice-scale scene in a world of one rank over NCCL, with and without
    the camera partition: the same cost log and CG counts as [pcg venice]
    (one shard holds the whole problem, and a one-rank sum is the value
    itself), launches equal to the logs; then solve_sharded's dense route on
    the headline scene, its projection kernel held to plain on the shard.
    Returns {kernel: launches}."""
    from pysfm_tpu_torch import dist
    from pysfm_tpu_torch.dist import multihost
    from pysfm_tpu_torch.utils import collectives
    from pysfm_tpu_torch.dist.sharded_lm import _local_problem
    from pysfm_tpu_torch.pipeline import synthetic
    from pysfm_tpu_torch.solver import LMConfig
    from pysfm_tpu_torch.solver.kernels import proj, spmv

    p, st_single, secs_single = venice
    multihost.initialize(f"localhost:{multihost.free_port()}", 1, 0, backend="nccl",
                         device="cuda:0", timeout=DIST_TIMEOUT)
    mesh = multihost.global_mesh(device="cuda:0")
    # NCCL builds its communicator at the first collective: out of the timings.
    _, t_nccl = _timed(lambda: collectives.psum(torch.ones(1, device="cuda:0"), mesh))
    (local, gops), t_put = _timed(
        lambda: dist.device_put_sharded_cm(dist.shard_cm_problem(p, 1), mesh))
    cfg = LMConfig(max_iters=VENICE_ITERS, **NO_TOL, **PCG_VENICE)
    n_single = int(st_single.n_iters)
    counts = dict.fromkeys(spmv.LAUNCHES, 0)
    for cam_axis in (False, True):
        label = f"dist venice{' cam_axis' if cam_axis else ''}"
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        collectives.reset_counts()
        (_, st), secs = _timed(
            lambda: dist.solve_sharded_cm(local, gops, mesh, cfg, cam_axis=cam_axis))
        run = _check_counts(label, cfg, st)
        for k in counts:
            counts[k] += run[k]
        note = _same_log(label, st, st_single, DIST_RTOL_VENICE)
        n, n_cg = int(st.n_iters), int(st.cg_iters.sum())
        print(f"[{label}] world of 1 (nccl), C={p.n_cameras} P={p.n_points} M={p.n_obs}: "
              f"cost log and CG counts against [pcg venice]: {note}; launches {run} == "
              f"LM/CG logs; {1e3 * secs / n:.1f} ms per LM iteration ([pcg venice] "
              f"{1e3 * secs_single / n_single:.1f}); {_collectives_note(n, n_cg)}; max memory "
              f"allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {smi}")
    print(f"[dist venice] first NCCL collective (communicator set-up) {t_nccl:.3f} s; "
          f"shard_cm_problem + device_put_sharded_cm (host partition, kernel layout) "
          f"{t_put:.3f} s")

    # solve_sharded's dense route (cm, f32 on the card: the projection kernel).
    pm = synthetic.make_scene(**MAIN_SCENE, device="cuda").problem
    sp = dist.device_put_sharded(dist.shard_problem(pm, 1), mesh)
    err, ok = _kernel_vs_plain(_local_problem(sp))
    if not ok:
        raise AssertionError(f"dist venice dense: projection kernel vs plain on the shard, "
                             f"max err {err}")
    dcfg = LMConfig(max_iters=N_ITERS, **NO_TOL)
    _reset_counts()
    (_, st), secs = _timed(lambda: dist.solve_sharded(sp, mesh, dcfg))
    launches = proj.LAUNCHES
    if launches != int(st.n_iters) or any(spmv.LAUNCHES.values()):
        raise AssertionError(f"dist venice dense: projection kernel launched {launches} times "
                             f"in {int(st.n_iters)} iterations, pcg kernels {spmv.LAUNCHES}")
    c = st.costs.cpu().numpy()
    rel = float(np.max(np.abs(c.astype(np.float64) - main_costs) / np.abs(main_costs)))
    if not rel <= DIST_RTOL_VENICE:
        raise AssertionError(f"dist venice dense: costs vs [main] rel {rel} "
                             f"(gate {DIST_RTOL_VENICE})")
    print(f"[dist venice] solve_sharded dense cm, headline scene M={pm.n_obs}, world of 1: "
          f"projection kernel vs plain on the shard max abs err {err:.3e}; {launches} launches "
          f"in {int(st.n_iters)} LM iterations; costs vs [main] "
          f"{'bitwise equal' if rel == 0.0 else f'max rel {rel:.3e}'} (gate "
          f"{DIST_RTOL_VENICE}); {1e3 * secs / int(st.n_iters):.2f} ms per LM iteration | {smi}")
    multihost.shutdown()
    return {"proj_cm": launches, **counts}


def _dist_rank(mesh, dtype_name):
    """One rank of [dist ranks]: this rank's shard of DIST_SCENE on the
    card; in f32 the kernel route with and without the camera partition
    (launches checked against the logs on this rank), and on rank 0 the
    five kernels of the path held to their plain versions on the shard's
    own layout; in f64 the plain route.  Returns the logs and counts."""
    from pysfm_tpu_torch import dist
    from pysfm_tpu_torch.dist import multihost
    from pysfm_tpu_torch.utils import collectives
    from pysfm_tpu_torch.dist.sharded_cm import _local_cm
    from pysfm_tpu_torch.pipeline import synthetic
    from pysfm_tpu_torch.solver import LMConfig
    from pysfm_tpu_torch.solver.kernels import proj, spmv

    dtype = getattr(np, dtype_name)
    cmp = synthetic.make_bal_scene(**{**DIST_SCENE, "dtype": dtype}, device=mesh.device).problem
    kernels = dtype == np.float32
    local, gops = multihost.shard_cm_problem_multihost(cmp, mesh, with_grouped=kernels)
    cfg = LMConfig(**DIST_CFG)
    n_obs = int(local.pt_obs_maskT[0].sum())
    out = {"rank": mesh.rank, "n_obs": n_obs, "runs": {}}
    # One LM iteration first: the rank's CUDA libraries load out of the timings.
    dist.solve_sharded_cm(local, gops, mesh, dataclasses.replace(cfg, max_iters=1))
    for cam_axis in ((False, True) if kernels else (False,)):
        _reset_counts()
        collectives.reset_counts()
        (_, st), secs = _timed(
            lambda: dist.solve_sharded_cm(local, gops, mesh, cfg, cam_axis=cam_axis))
        if kernels:
            counts = _check_counts(f"dist ranks rank {mesh.rank} cam_axis={cam_axis}", cfg, st)
        elif any(spmv.LAUNCHES.values()):
            raise AssertionError(f"dist ranks f64: the plain route launched {spmv.LAUNCHES}")
        else:
            counts = dict(spmv.LAUNCHES)
        counts["proj_cm"] = proj.LAUNCHES
        n, n_cg = int(st.n_iters), int(st.cg_iters.sum())
        out["runs"][cam_axis] = dict(costs=st.costs.cpu().numpy(),
                                     cg=st.cg_iters.cpu().numpy(), counts=counts, secs=secs,
                                     collectives=_collectives_note(n, n_cg))
    if kernels and mesh.rank == 0:
        lp = _local_cm(local)
        args, kw = _eqs_args(lp, gops)
        eqs, b_rows, b_cam = spmv.build_eqs(*args, **kw)
        pairs = _spmv_pairs(lp, gops, eqs, b_rows, b_cam)
        out["kernel_err"] = {name: _check_pair(name, *pairs[name], False)
                             for name in ("build_eqs", "cost", "hcpT_x", "hcp_w",
                                          "precond_diag")}
        out["kernel_err"]["cost"] = max(out["kernel_err"]["cost"],
                                        _cost_checks("dist ranks", lp, gops))
    return out


def phase_dist_ranks(smi) -> dict:
    """Two ranks on the one card over gloo with CUDA tensors ([bal io]'s
    scene, ~313k observations a rank): f32 with the kernels (with and
    without the camera partition) against the single-device kernel solve,
    f64 on the plain route against the single-device f64 solve (equal CG
    counts); the kernels of the path held to plain on rank 0's shard.
    Returns {kernel: launches over both ranks}."""
    from pysfm_tpu_torch.dist import launch
    from pysfm_tpu_torch.pipeline import synthetic
    from pysfm_tpu_torch.solver import LMConfig, solve
    from pysfm_tpu_torch.solver.lm import make_grouped_ops

    cfg = LMConfig(**DIST_CFG)
    counts = dict.fromkeys(("proj_cm",) + tuple(SPMV_KERNELS), 0)
    for dtype_name, rtol in (("float32", DIST_RTOL_F32), ("float64", DIST_RTOL_F64)):
        cmp = synthetic.make_bal_scene(**{**DIST_SCENE, "dtype": getattr(np, dtype_name)},
                                       device="cuda").problem
        gops = make_grouped_ops(cmp) if dtype_name == "float32" else None
        (_, ref), secs_ref = _timed(lambda: solve(cmp, cfg, gops=gops))
        del cmp, gops
        torch.cuda.empty_cache()
        (ranks), secs = _timed(lambda: launch.spawn(
            _dist_rank, 2, (dtype_name,), backend="gloo", device="cuda:0",
            timeout=DIST_TIMEOUT))
        c_ref, cg_ref = ref.costs.cpu().numpy().astype(np.float64), ref.cg_iters.cpu().numpy()
        n = int(ref.n_iters)
        for cam_axis, run in ranks[0]["runs"].items():
            for r in ranks[1:]:
                if not np.array_equal(r["runs"][cam_axis]["costs"], run["costs"]):
                    raise AssertionError("dist ranks: the ranks' cost logs differ")
            rel = float(np.max(np.abs(run["costs"] - c_ref) / np.abs(c_ref)))
            same_cg = bool(np.array_equal(run["cg"], cg_ref))
            if not rel <= rtol or (dtype_name == "float64" and not same_cg):
                raise AssertionError(
                    f"dist ranks {dtype_name} cam_axis={cam_axis}: costs rel {rel:.3e} (gate "
                    f"{rtol}), CG {run['cg'].tolist()} vs single device {cg_ref.tolist()}")
            for r in ranks:
                for k, v in r["runs"][cam_axis]["counts"].items():
                    counts[k] += v
            launched = (f"launches by rank {[r['runs'][cam_axis]['counts'] for r in ranks]} == "
                        "each rank's LM/CG logs" if dtype_name == "float32"
                        else "no kernel launch (the f64 plain route)")
            print(f"[dist ranks] {dtype_name} cam_axis={cam_axis}, 2 ranks on cuda:0 (gloo), "
                  f"P={DIST_SCENE['n_points']}, M={ranks[0]['n_obs']} + "
                  f"{ranks[1]['n_obs']} observations by rank: costs vs single device max rel "
                  f"{rel:.3e} (gate {rtol}), CG counts equal {same_cg} ({run['cg'].tolist()}); "
                  f"{launched}; {1e3 * run['secs'] / n:.1f} ms per LM iteration "
                  f"(single device {1e3 * secs_ref / n:.1f}); rank 0 {run['collectives']}; "
                  f"gloo takes reduce_scatter / all_gather as all_reduce "
                  f"(collectives._scatter_by_all_reduce / _gather_by_all_reduce) | {smi}")
        if dtype_name == "float32":
            print(f"[dist ranks] rank 0's shard, kernel vs plain max abs err (KERNEL_TOL "
                  f"{KERNEL_TOL}): {ranks[0]['kernel_err']}; world of 2 spawned, solved and "
                  f"joined in {secs:.1f} s")
    return counts


# BASELINE config 2 as bench.py runs it, and bench/incremental_scale.py's
# scene; tests/test_pipeline.py's gates (0.5 px noise) and
# tests/test_tracks.py's.
INCR_SCENE = dict(noise_px=0.5, seed=13, radius=10.0)
INCR_ATE, INCR_RMSE_PX, INCR_POINTS = 2e-2, 1.0, 0.9
IMAGES_ATE, IMAGES_RMSE_PX = 0.15, 1.5
FRAME_TOL = 1e-9
# f64 card and host runs fed the same draws: camera centres within this
# (ATE after Sim(3)); the rest of the two runs must be equal.
INCR_CARD_HOST = 1e-9


def _track_table(n_frames, n_points, visibility, dtype):
    """(uv [F, T, 2], vis [F, T], intr [F, 4], truth problem): a synthetic
    scene's observations as a dense track table of ``dtype``, the truth
    kept on the host in f64 for the ATE."""
    from pysfm_tpu_torch.pipeline import synthetic

    truth = synthetic.make_scene(n_frames, n_points, visibility=visibility, dtype=np.float64,
                                 device="cpu", **INCR_SCENE).truth
    oc, op = truth.obs_cam.numpy(), truth.obs_pt.numpy()
    uv = np.zeros((n_frames, n_points, 2), dtype)
    vis = np.zeros((n_frames, n_points), bool)
    uv[oc, op] = truth.obs_uv.numpy()
    vis[oc, op] = True
    return uv, vis, truth.intr.numpy().astype(dtype), truth


def _ate(rec, R_gt, t_gt) -> float:
    """ATE of a reconstruction's camera centres against (R_gt, t_gt), after
    Sim(3) alignment, in f64 on the host."""
    from pysfm_tpu_torch.utils import metrics

    C = metrics.camera_centers(rec.problem.R.double().cpu(), rec.problem.t.double().cpu())
    return float(metrics.ate_rmse(C, metrics.camera_centers(R_gt, t_gt)))


@contextlib.contextmanager
def _recording_ba(problems, iters=None):
    """While open, every problem an incremental run hands to its BA solve
    (window and full) goes into ``problems`` as the solve received it, and
    each solve's LM iterations into ``iters``."""
    from pysfm_tpu_torch.pipeline import incremental

    solve = incremental.solve

    def recording_solve(prob, config):
        problems.append(prob)
        out = solve(prob, config)
        if iters is not None:
            iters.append(int(out[1].n_iters))
        return out

    incremental.solve = recording_solve
    try:
        yield
    finally:
        incremental.solve = solve


def _incremental_run(label, table, cfg, device="cuda", sampler=None, gates=True,
                     problems=None):
    """One run_incremental, its wall time, and the gates of
    tests/test_pipeline.py; returns (reconstruction, seconds, ate, rmse).
    ``problems``: a list that receives every problem the run hands to its
    BA solve (``_recording_ba``)."""
    from pysfm_tpu_torch.pipeline import run_incremental
    from pysfm_tpu_torch.utils import metrics

    uv, vis, intr, truth = table
    with contextlib.nullcontext() if problems is None else _recording_ba(problems):
        rec, secs = _timed(lambda: run_incremental(uv, vis, intr, "pose", cfg, device=device,
                                                   sampler=sampler))
    ate = _ate(rec, truth.R, truth.t)
    rmse = metrics.reprojection_rmse(rec.problem)
    if not rec.registered.all():
        raise AssertionError(f"{label}: registered {int(rec.registered.sum())} of "
                             f"{len(rec.registered)} frames")
    if gates and not (rec.has_point.mean() > INCR_POINTS and rmse < INCR_RMSE_PX):
        raise AssertionError(f"{label}: has_point {rec.has_point.mean():.3f}, rmse {rmse:.3f} px")
    if not ate < INCR_ATE:
        raise AssertionError(f"{label}: ATE {ate:.3e} (gate {INCR_ATE})")
    return rec, secs, ate, rmse


def _kernel_per_solve(label, rec, launches):
    """The f32 track table takes the projection kernel in every BA solve."""
    from pysfm_tpu_torch.solver.kernels import spmv

    n_ba = len(rec.stats["ba_costs"])
    if launches < n_ba or any(spmv.LAUNCHES.values()):
        raise AssertionError(f"{label}: projection kernel launched {launches} times for "
                             f"{n_ba} BA solves; pcg kernels {spmv.LAUNCHES} (expected none)")
    return n_ba


def _kernel_on_path(label, problems) -> str:
    """The projection kernel against its plain version on the problems an
    incremental run gave its BA solves (Cauchy at the configured scale,
    gauge-fixed and padded identity cameras, zero-weight padded
    observations, window M a power of two from 512, full-BA M = nnz(vis)),
    and on the run's final full-shape problem, at KERNEL_TOL.  These
    launches come after the path's counts were read and are not counted
    for it."""
    worst, by_branch, ms = 0.0, {"M % 4 == 0": 0, "M % 4 != 0": 0}, set()
    for p in problems:
        err, ok = _kernel_vs_plain(p)
        if not ok:
            raise AssertionError(f"{label}: projection kernel != plain at M={p.n_obs}, "
                                 f"robust {p.robust}: max abs err {err:.3e}")
        worst = max(worst, err)
        by_branch["M % 4 == 0" if p.n_obs % 4 == 0 else "M % 4 != 0"] += 1
        ms.add(p.n_obs)
    return (f"projection kernel == plain on the path's {len(problems)} problems "
            f"(M in {sorted(ms)}; {by_branch}, the kernel takes 4 observations a thread "
            f"where M % 4 == 0): max abs err {worst:.3e} "
            f"(bound {KERNEL_TOL} x (max|ref|+1))")


def phase_incremental(smi) -> int:
    """BASELINE config 2 (bench.py): 10 keyframes, 1k points, an f32 track
    table through run_incremental on the card twice; the same scene as an
    f64 table on the card and on the host, both fed the same minimal sets
    by a host generator, which must agree.  Returns the projection kernel's
    launches on the path."""
    from pysfm_tpu_torch.frontend import ransac
    from pysfm_tpu_torch.pipeline import IncrementalConfig
    from pysfm_tpu_torch.solver.kernels import proj
    from pysfm_tpu_torch.utils import metrics

    cfg = IncrementalConfig(seed=2)
    table = _track_table(10, 1000, 0.85, np.float32)
    F = table[1].shape[0]
    _reset_counts()
    runs, path_launches = [], 0
    for k in range(2):
        before, problems = proj.LAUNCHES, []
        rec, secs, ate, rmse = _incremental_run(f"incremental f32 run {k + 1}", table, cfg,
                                                problems=problems)
        n_launch = proj.LAUNCHES - before
        n_ba = _kernel_per_solve("incremental", rec, n_launch)
        path_launches += n_launch
        held = _kernel_on_path(f"incremental f32 run {k + 1}", problems + [rec.problem])
        runs.append((rec, secs, ate, rmse, n_ba, n_launch, held))
    table64 = _track_table(10, 1000, 0.85, np.float64)
    f32_launches = proj.LAUNCHES
    out = {}
    for dev in ("cuda", "cpu"):
        out[dev] = _incremental_run(f"incremental f64 on {dev}", table64, cfg, device=dev,
                                    sampler=ransac.generator_sampler(2, "cpu"))
    if proj.LAUNCHES != f32_launches:
        raise AssertionError("incremental: an f64 table launched the projection kernel "
                             f"{proj.LAUNCHES - f32_launches} times (it takes the plain route)")
    (rc, _, ate_c, _), (rh, _, ate_h, _) = out["cuda"], out["cpu"]
    C = [metrics.camera_centers(r.problem.R.cpu(), r.problem.t.cpu()) for r in (rc, rh)]
    d_centres = float(metrics.ate_rmse(C[0], C[1]))
    same = (rc.stats["init_pair"] == rh.stats["init_pair"]
            and rc.stats["pnp_inliers"] == rh.stats["pnp_inliers"])
    if not (same and d_centres < INCR_CARD_HOST):
        raise AssertionError(
            f"incremental f64: card and host disagree on the same draws: init pair "
            f"{rc.stats['init_pair']} vs {rh.stats['init_pair']}, pnp inliers equal "
            f"{rc.stats['pnp_inliers'] == rh.stats['pnp_inliers']}, camera centres "
            f"{d_centres:.3e} apart (bound {INCR_CARD_HOST})")
    for k, (rec, secs, ate, rmse, n_ba, n_launch, held) in enumerate(runs):
        print(f"[incremental] f32 run {k + 1}: {F / secs:.3f} frames/s ({secs:.3f} s), ATE "
              f"{ate:.3e}, rmse {rmse:.4f} px, has_point {rec.has_point.mean():.3f}, init pair "
              f"{rec.stats['init_pair']}, {n_ba} BA solves, {n_launch} projection-kernel "
              f"launches; {held} | {smi}")
    print(f"[incremental] stage seconds of run 2 (fenced): {runs[1][0].stats['timings_s']}")
    print(f"[incremental] f64 table, one host generator's draws: card and host init pair "
          f"{rc.stats['init_pair']}, registered {int(rc.registered.sum())} and "
          f"{int(rh.registered.sum())}, pnp inlier lists equal, ATE {ate_c:.3e} and "
          f"{ate_h:.3e}; camera centres card vs host after Sim(3) {d_centres:.3e} "
          f"(bound {INCR_CARD_HOST})")
    return path_launches


def phase_incremental_scale(smi) -> int:
    """bench/incremental_scale.py's scene (50 keyframes, 2k points,
    visibility 0.35) as an f32 track table, run twice in one process, then
    a third time under torch.profiler for the device's idle share."""
    from pysfm_tpu_torch.pipeline import IncrementalConfig
    from pysfm_tpu_torch.solver.kernels import proj

    cfg = IncrementalConfig(seed=2)
    table = _track_table(50, 2000, 0.35, np.float32)
    F = table[1].shape[0]
    _reset_counts()
    lines, path_launches = [], 0
    for k in range(2):
        before, problems = proj.LAUNCHES, []
        rec, secs, ate, rmse = _incremental_run(f"incremental scale run {k + 1}", table, cfg,
                                                gates=False, problems=problems)
        n_launch = proj.LAUNCHES - before
        n_ba = _kernel_per_solve("incremental scale", rec, n_launch)
        path_launches += n_launch
        held = _kernel_on_path(f"incremental scale run {k + 1}", problems + [rec.problem])
        lines.append(f"[incremental scale] run {k + 1}: {F / secs:.3f} frames/s ({secs:.3f} s), "
                     f"ATE {ate:.3e}, rmse {rmse:.4f} px, has_point {rec.has_point.mean():.3f}, "
                     f"{n_ba} BA solves, {n_launch} projection-kernel launches; stage seconds "
                     f"(fenced) {rec.stats['timings_s']}; {held} | {smi}")
    print("\n".join(lines))
    (rec, _, _, _), secs, dev, busy_ms = _traced(
        lambda: _incremental_run("incremental scale traced run", table, cfg, gates=False))
    print(f"[incremental scale profile] run 3 traced in {secs:.3f} s ({F / secs:.3f} frames/s "
          f"under the profiler): device busy {busy_ms:.1f} ms, idle share "
          + ("not measured (the trace holds no device time)" if busy_ms <= 0.0 else
             f"{1 - busy_ms / (1e3 * secs):.3f}") + f"; {sum(e.count for e in dev)} device "
          f"kernels; fenced stage seconds {rec.stats['timings_s']}; most device time: "
          + _top_device(dev) + f" | {smi}")
    return path_launches


def phase_images(smi) -> None:
    """tests/test_tracks.py's dot video through run_from_images on the card
    (its gates), then the front end on one camera-size frame pair: f64 on
    the card against f64 on the host, and the f32 time on the card."""
    from pysfm_tpu_torch.frontend import features, match
    from pysfm_tpu_torch.pipeline import IncrementalConfig, TrackingConfig, run_from_images
    from pysfm_tpu_torch.utils import metrics

    images, centers, _, _ = dot_video()
    intr = np.tile(np.array([DOT_F, DOT_F, DOT_W / 2, DOT_H / 2]), (images.shape[0], 1))
    cfg = IncrementalConfig(seed=4, pnp_threshold=3e-5, epipolar_threshold=3e-5)
    rec, secs = _timed(lambda: run_from_images(
        images, intr, "pose", tracking=TrackingConfig(n_keypoints=256),
        incremental_config=cfg))
    C = metrics.camera_centers(rec.problem.R.cpu(), rec.problem.t.cpu())
    ate = float(metrics.ate_rmse(C, torch.as_tensor(centers)))
    rmse = metrics.reprojection_rmse(rec.problem)
    if not (rec.registered.all() and ate < IMAGES_ATE and rmse < IMAGES_RMSE_PX):
        raise AssertionError(f"images: registered {int(rec.registered.sum())}/"
                             f"{len(rec.registered)}, ATE {ate:.3e}, rmse {rmse:.3f} px")
    print(f"[images] run_from_images, {images.shape[0]} frames of {DOT_H}x{DOT_W}: "
          f"{images.shape[0] / secs:.3f} frames/s ({secs:.3f} s), {rec.problem.n_points} "
          f"tracks, ATE {ate:.3e}, rmse {rmse:.4f} px | {smi}")

    frames = dot_video(shape=CAMERA_FRAME, n_pts=1500)[0][:2]
    n_kp = TrackingConfig().n_keypoints

    def front(img):
        kp, d = features.detect_and_describe(img, n_kp)
        m = match.match_descriptors(d[0], d[1], valid1=kp.valid[0], valid2=kp.valid[1],
                                    min_similarity=0.85, ratio=0.75)
        return kp, d, m

    outs = [[t.cpu() for t in (kp.xy, kp.valid, d, m.valid, m.idx2)]
            for kp, d, m in (front(torch.as_tensor(frames, device=dev)) for dev in ("cuda", "cpu"))]
    (xy_c, v_c, d_c, mv_c, mi_c), (xy_h, v_h, d_h, mv_h, mi_h) = outs
    for f in range(2):
        oc = np.argsort(_pixel_keys(xy_c[f][v_c[f]]))
        oh = np.argsort(_pixel_keys(xy_h[f][v_h[f]]))
        same = (int(v_c[f].sum()) == int(v_h[f].sum())
                and np.array_equal(_pixel_keys(xy_c[f][v_c[f]])[oc],
                                   _pixel_keys(xy_h[f][v_h[f]])[oh]))
        err_xy = float((xy_c[f][v_c[f]][oc] - xy_h[f][v_h[f]][oh]).abs().max()) if same else 0
        err_d = float((d_c[f][v_c[f]][oc] - d_h[f][v_h[f]][oh]).abs().max()) if same else 0
        if not (same and err_xy <= FRAME_TOL and err_d <= FRAME_TOL):
            raise AssertionError(f"images: frame {f} card vs host keypoint sets equal {same}, "
                                 f"xy err {err_xy}, descriptor err {err_d}")
    n_match = int(mv_c.sum())
    if n_match != int(mv_h.sum()):
        raise AssertionError(f"images: card {n_match} matches, host {int(mv_h.sum())}")
    img32 = torch.as_tensor(frames, dtype=torch.float32, device="cuda")
    ms = _device_ms(lambda: front(img32), n=10)
    call_ms = _host_ms(lambda: front(img32), n=10)
    print(f"[images] front end on a {CAMERA_FRAME[0]}x{CAMERA_FRAME[1]} frame pair "
          f"({n_kp} keypoints, {int(v_c.sum())} valid): f64 card == host keypoint sets, xy and "
          f"descriptors within {FRAME_TOL}, {n_match} matches on both; f32 detect_and_describe "
          f"(2 frames) + match: device {ms:.4f} ms, call with host overhead {call_ms:.4f} ms "
          f"| {smi}")


def _pixel_keys(xy: torch.Tensor) -> np.ndarray:
    """A keypoint's integer pixel (row-major flat index of its rounded
    position): the key by which keypoint sets are compared."""
    p = torch.round(xy.double()).long()
    return (p[:, 1] * 100_000 + p[:, 0]).numpy()


# The runnable examples of pysfm_tpu_torch/examples, each under its own gate.
def _expected_bal_example(out) -> dict:
    """The pcg kernels' launches that the bal example's three solves imply
    from their LM/CG logs: 8 iterations, 8 resumed from the checkpoint with
    the CG warm start, 16 uninterrupted."""
    parts = [_expected_launches(out["stats"], out["config"]),
             _expected_launches(out["stats_resumed"], out["config"]),
             _expected_launches(out["stats_full"], out["config_full"])]
    return {k: sum(part[k] for part in parts) for k in parts[0]}


def phase_examples(smi) -> dict:
    """The four examples of ``pysfm_tpu_torch/examples`` on the card, each
    through its ``run()`` and under its own gate: ``two_view_ba`` (one
    projection-kernel launch an LM iteration), ``incremental_sfm`` (one an
    LM iteration of each BA solve), ``bal_checkpoint_resume`` with the pcg
    kernels (launches equal to the three solves' LM/CG logs) and on the JAX
    script's literal route (no kernel), and ``distributed_ba`` as a world of
    one rank over NCCL.  Each example's counts are set to 0 just before it
    and read just after; then its kernels are held to their plain versions
    on its own problems.  Returns {kernel: launches on the phase}."""
    from pysfm_tpu_torch.examples import (
        bal_checkpoint_resume,
        distributed_ba,
        incremental_sfm,
        two_view_ba,
    )
    from pysfm_tpu_torch.problem import cm
    from pysfm_tpu_torch.solver.kernels import proj, spmv
    from pysfm_tpu_torch.solver.lm import make_grouped_ops

    counts = dict.fromkeys(("proj_cm",) + SPMV_KERNELS, 0)
    t_phase = time.perf_counter()

    _reset_counts()
    out, secs = _timed(two_view_ba.run)
    n, launches = out["n_iters"], proj.LAUNCHES
    if launches != n or any(spmv.LAUNCHES.values()):
        raise AssertionError(f"examples two_view_ba: projection kernel launched {launches} "
                             f"times in {n} LM iterations; pcg kernels {spmv.LAUNCHES}")
    counts["proj_cm"] += launches
    gate = 2.0 * two_view_ba.NOISE_PX
    if not out["rmse"] < gate:
        raise AssertionError(f"examples two_view_ba: RMSE {out['rmse']:.4f} px (gate {gate})")
    errs = [_proj_vs_plain_cm("examples two_view_ba", cm.from_problem(q))[0]
            for q in (out["problem"], out["solved"])]
    print(f"[examples] two_view_ba: {out['n_cameras']} cams / {out['n_points']} pts / "
          f"{out['n_obs']} obs, cost {out['cost0']:.2f} -> {out['cost']:.4f} in {n} iters "
          f"({out['accepted']} accepted), RMSE {out['rmse']:.4f} px (gate < {gate}); "
          f"{launches} projection-kernel launches == LM iterations; kernel == plain on the "
          f"initial and solved problems, both branches, max abs err {max(errs):.3e}; "
          f"{secs:.3f} s | {smi}")

    _reset_counts()
    problems, iters = [], []
    with _recording_ba(problems, iters):
        out, secs = _timed(incremental_sfm.run)
    rec, launches = out["rec"], proj.LAUNCHES
    if (launches != sum(iters) or len(iters) != len(rec.stats["ba_costs"])
            or any(spmv.LAUNCHES.values())):
        raise AssertionError(f"examples incremental_sfm: projection kernel launched {launches} "
                             f"times for BA solves of {iters} LM iterations; pcg kernels "
                             f"{spmv.LAUNCHES}")
    counts["proj_cm"] += launches
    if not (rec.registered.all() and out["ate"] < incremental_sfm.ATE_GATE):
        raise AssertionError(f"examples incremental_sfm: registered {out['registered']}/"
                             f"{out['n_frames']}, ATE {out['ate']:.3e} "
                             f"(gate {incremental_sfm.ATE_GATE})")
    held = _kernel_on_path("examples incremental_sfm", problems + [rec.problem])
    print(f"[examples] incremental_sfm: registered {out['registered']}/{out['n_frames']} "
          f"frames, {out['n_points']} points, ATE {out['ate']:.5f} (gate < "
          f"{incremental_sfm.ATE_GATE}), RMSE {out['rmse']:.3f} px; {len(iters)} BA solves of "
          f"{sum(iters)} LM iterations, {launches} projection-kernel launches; {held}; "
          f"{secs:.3f} s | {smi}")

    for grouped in (None, False):
        _reset_counts()
        out, secs = _timed(lambda: bal_checkpoint_resume.run(grouped=grouped))
        got = dict(spmv.LAUNCHES)
        expected = (_expected_bal_example(out) if out["grouped"]
                    else dict.fromkeys(SPMV_KERNELS, 0))
        if got != expected or proj.LAUNCHES:
            raise AssertionError(f"examples bal_checkpoint_resume (kernels {out['grouped']}): "
                                 f"launches {got} (proj {proj.LAUNCHES}), expected {expected}")
        for k, v in got.items():
            counts[k] += v
        c_res, c_full = out["c_resumed"], out["c_full"]
        rel = abs(c_res - c_full) / abs(c_full)
        if not rel <= bal_checkpoint_resume.RTOL:
            raise AssertionError(f"examples bal_checkpoint_resume (kernels {out['grouped']}): "
                                 f"resumed {c_res} vs uninterrupted {c_full}, rel {rel:.3e}")
        held = "no kernel on the JAX script's literal route"
        if out["grouped"]:
            cmp = cm.from_problem(out["problem"])
            errs, _ = _kernels_vs_plain(cmp, make_grouped_ops(cmp))
            held = (f"launches {got} == the three solves' LM/CG logs; kernels == plain on the "
                    f"example's problem, max abs err {errs}")
        print(f"[examples] bal_checkpoint_resume, kernels {out['grouped']}: {out['n_cameras']} "
              f"cams / {out['n_points']} pts / {out['n_obs']} obs, cost {out['cost0']:.1f} -> "
              f"{c_res:.4f} resumed across a checkpoint vs {c_full:.4f} uninterrupted (rel "
              f"{rel:.3e}, gate {bal_checkpoint_resume.RTOL}); CG "
              f"{out['stats'].cg_iters.tolist()} + {out['stats_resumed'].cg_iters.tolist()}; "
              f"{held}; {secs:.3f} s | {smi}")

    _reset_counts()
    out, secs = _timed(lambda: distributed_ba.run(nproc=1, timeout=DIST_TIMEOUT))
    if any(spmv.LAUNCHES.values()) or proj.LAUNCHES:
        raise AssertionError(f"examples distributed_ba: launches {spmv.LAUNCHES} (proj "
                             f"{proj.LAUNCHES}); its route passes no grouped ops")
    if not out["rel"] < distributed_ba.RTOL:
        raise AssertionError(f"examples distributed_ba: deviation {out['rel']:.2e} "
                             f"(gate {distributed_ba.RTOL})")
    cd = out["costs"]
    print(f"[examples] distributed_ba --nproc 1 (NCCL, cuda:0): cost {cd[0]:.1f} -> "
          f"{cd[-1]:.4f}; max rel deviation vs the single-device trajectory {out['rel']:.2e} "
          f"(gate < {distributed_ba.RTOL}); no kernel (the example passes no grouped ops); "
          f"spawned, solved and joined in {secs:.3f} s | {smi}")
    print(f"[examples] phase {time.perf_counter() - t_phase:.1f} s; launches {counts}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; the port has no CPU fallback here",
              file=sys.stderr)
        return 1
    _import_port()
    from pysfm_tpu_torch.pipeline import synthetic
    from pysfm_tpu_torch.solver.kernels import spmv

    smi = phase_env()
    phase_build()
    phase_kernel_small()
    t0 = time.perf_counter()
    p = synthetic.make_scene(**MAIN_SCENE, device="cuda").problem
    print(f"[scene] 50 cams / 10k pts / {p.n_obs} obs, f32 on "
          f"{torch.cuda.get_device_name(0)}, built in {time.perf_counter() - t0:.2f} s")
    kstats = phase_kernel_main(p, smi)
    launches, main_costs = phase_main(p)
    phase_speed(p, smi)
    std = phase_std(p, smi)
    phase_spmv_small()
    pcg_stats, pcg_counts = phase_pcg_main(smi)
    proj_venice = phase_proj_venice(smi)
    venice_stats, venice_counts, venice = phase_pcg_venice(smi)
    dist_venice = phase_dist_venice(smi, venice, main_costs)
    del venice
    dist_ranks = phase_dist_ranks(smi)
    io_counts = phase_bal_io(smi)
    incr_launches = phase_incremental(smi)
    incr_counts = dict(spmv.LAUNCHES)
    scale_launches = phase_incremental_scale(smi)
    scale_counts = dict(spmv.LAUNCHES)
    phase_images(smi)
    examples = phase_examples(smi)

    # Launches on each main path, each read just after the path ran with
    # the counts set to 0 just before it.
    proj_paths = {"main": launches, "std": std["launches"], "incremental": incr_launches,
                  "incremental scale": scale_launches, "dist venice": dist_venice["proj_cm"],
                  "dist ranks": dist_ranks["proj_cm"], "examples": examples["proj_cm"]}
    kernels = [{
        "name": "proj_cm",
        "route": "cuda",
        "source": "pysfm_tpu_torch/csrc/proj.cu",
        "replaces": "pysfm_tpu/solver/kernels/pallas_proj.py:214 (std route: :285)",
        "launches": sum(proj_paths.values()),
        "launches_by_path": proj_paths,
        **kstats,
        "venice": proj_venice,
    }]
    for name in SPMV_KERNELS:
        source, replaces = SPMV_SOURCE[name]
        st = pcg_stats[name]
        paths = {"pcg main": pcg_counts[name], "pcg venice": venice_counts[name],
                 "bal io": io_counts[name], "incremental": incr_counts[name],
                 "incremental scale": scale_counts[name], "dist venice": dist_venice[name],
                 "dist ranks": dist_ranks[name], "examples": examples[name]}
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": sum(paths.values()),
                        "launches_by_path": paths,
                        **st, "venice": venice_stats[name]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
