#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. environment: torch, CUDA, nvcc and the card (name, power limit);
2. build: nvcc compiles ``pysfm_tpu_torch/csrc/*.cu`` for sm_90a;
3. kernel against its plain PyTorch version on the card: every camera
   model x robust kernel on a small scene with a ragged observation count,
   and the main-path shape (50 cameras, 10k points, ~164k observations);
4. main path: ``solve()`` with the default ``LMConfig`` route (dense
   component-major Schur LM, ``jac_backend="auto"``) for 30 iterations on
   the 50-camera / 10k-point Huber scene, checked against the plain route
   on the card and, on a small scene, against the f64 plain route on the
   host; then LM iterations/s and kernel times.

The second-to-last lines are the card's ``nvidia-smi`` name and power
limit and one JSON object describing each kernel; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
``pysfm_tpu_torch`` package beside this script, it exits non-zero and
prints no result.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

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


def phase_build() -> float:
    from pysfm_tpu_torch.solver.kernels import _build

    info = _build.build()
    _build.library()
    regs = sorted({int(n) for n in re.findall(r"Used (\d+) registers", info.log)})
    spills = len([n for n in re.findall(r"(\d+) bytes spill stores", info.log) if n != "0"])
    print(f"[build] {info.path.name} built={info.built} nvcc {info.seconds:.2f} s; "
          f"registers/thread {regs}, kernels with spills: {spills}")
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
    refs = proj.proj_cm_plain(p.camera_model, p.robust, *proj._problem_args(p))
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
        R, t, intr, X, obs_cam, obs_pt, uv, w, free, scale = proj._problem_args(p)
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
    kernel, is the larger of the two).
    """
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        s0, s1, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s0.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        s1.record()
        t0 = time.perf_counter()
        fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        if host_ms >= s0.elapsed_time(s1):
            raise AssertionError(
                f"enqueueing took {host_ms:.2f} ms, longer than the sleep: "
                "the events would time host gaps")
        times.append(s1.elapsed_time(end))
    return statistics.median(times)


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

    def kernel():
        return proj.residuals_and_jacobians_cm(p)

    def plain():
        return proj.proj_cm_plain(p.camera_model, p.robust, *args)

    ms, plain_ms = _device_ms(kernel), _device_ms(plain)
    call_ms, plain_call_ms = _host_ms(kernel), _host_ms(plain)
    print(f"[kernel] main-path shape M={p.n_obs}: max abs err {err:.3e}; device time "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 20, CUDA events); "
          f"call with host overhead kernel {call_ms:.4f} ms, plain {plain_call_ms:.4f} ms "
          f"| {smi}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def _solve_timed(p, cfg):
    from pysfm_tpu_torch.solver import solve

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, stats = solve(p, cfg)
    torch.cuda.synchronize()
    return out, stats, time.perf_counter() - t0


def phase_main(p) -> int:
    from pysfm_tpu_torch.pipeline import synthetic
    from pysfm_tpu_torch.solver import LMConfig, solve
    from pysfm_tpu_torch.solver.kernels import proj

    cfg = LMConfig(max_iters=N_ITERS, tol_grad=0.0, tol_cost_rel=0.0, tol_step=0.0)
    proj.LAUNCHES = 0
    _, stats, _ = _solve_timed(p, cfg)
    launches = proj.LAUNCHES
    if launches != N_ITERS:
        raise AssertionError(f"main path launched the kernel {launches} times, expected {N_ITERS}")
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
    return launches


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; the port has no CPU fallback here",
              file=sys.stderr)
        return 1
    _import_port()
    from pysfm_tpu_torch.pipeline import synthetic

    smi = phase_env()
    phase_build()
    phase_kernel_small()
    t0 = time.perf_counter()
    p = synthetic.make_scene(**MAIN_SCENE, device="cuda").problem
    print(f"[scene] 50 cams / 10k pts / {p.n_obs} obs, f32 on "
          f"{torch.cuda.get_device_name(0)}, built in {time.perf_counter() - t0:.2f} s")
    kstats = phase_kernel_main(p, smi)
    launches = phase_main(p)
    phase_speed(p, smi)

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "proj_cm",
        "route": "cuda",
        "source": "pysfm_tpu_torch/csrc/proj.cu",
        "replaces": "pysfm_tpu/solver/kernels/pallas_proj.py:214",
        "launches": launches,
        **kstats,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
