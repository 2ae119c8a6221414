"""Bundler ``.out`` (v0.3) reconstruction file I/O.

Port of :mod:`pysfm_tpu.io.bundler`.  Format (Bundler v0.3):

    # Bundle file v0.3
    <n_cameras> <n_points>
    --- per camera ---
    <f> <k1> <k2>
    <R row 0>
    <R row 1>
    <R row 2>
    <t>
    --- per point ---
    <x y z>
    <r g b>
    <k> <cam_0> <key_0> <x_0> <y_0> ... <cam_{k-1}> <key_{k-1}> ...

Convention: identical to BAL (camera looks down -z, ``p = R X + t``,
projection ``-p/z`` with radial distortion): camera_model="bal".
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

from pysfm_tpu_torch.io.bal import _host64
from pysfm_tpu_torch.problem import BundleProblem, make_problem


class BundlerExtras(NamedTuple):
    """Side data the BA problem itself does not carry."""

    colors: np.ndarray       # [P, 3] uint8
    keys: np.ndarray         # [M] int32 keypoint index per observation


def load_bundler(
    path,
    *,
    robust: str = "gaussian",
    robust_scale: float = 1.0,
    dtype=np.float64,
    device="cuda",
) -> Tuple[BundleProblem, BundlerExtras]:
    """Load a Bundler v0.3 ``.out`` file onto ``device`` (the card unless
    the caller asks for the CPU)."""
    with open(path) as f:
        lines = [ln for ln in f if not ln.startswith("#")]
    tok = iter(" ".join(lines).split())

    def take(n):
        return np.array([float(next(tok)) for _ in range(n)])

    n_cam, n_pt = int(float(next(tok))), int(float(next(tok)))
    intr = np.zeros((n_cam, 3))
    R = np.zeros((n_cam, 3, 3))
    t = np.zeros((n_cam, 3))
    for c in range(n_cam):
        intr[c] = take(3)
        R[c] = take(9).reshape(3, 3)
        t[c] = take(3)
    X = np.zeros((n_pt, 3))
    colors = np.zeros((n_pt, 3), np.uint8)
    obs_cam, obs_pt, obs_uv, keys = [], [], [], []
    for p in range(n_pt):
        X[p] = take(3)
        colors[p] = take(3).astype(np.uint8)
        k = int(float(next(tok)))
        for _ in range(k):
            cam = int(float(next(tok)))
            key = int(float(next(tok)))
            u, v = float(next(tok)), float(next(tok))
            obs_cam.append(cam)
            obs_pt.append(p)
            keys.append(key)
            obs_uv.append((u, v))
    prob = make_problem(
        R, t, intr, X,
        np.array(obs_cam, np.int32), np.array(obs_pt, np.int32),
        np.array(obs_uv),
        camera_model="bal", robust=robust, robust_scale=robust_scale,
        dtype=dtype, device=device,
    )
    return prob, BundlerExtras(colors=colors, keys=np.array(keys, np.int32))


def save_bundler(
    path,
    problem: BundleProblem,
    *,
    colors: Optional[np.ndarray] = None,
    keys: Optional[np.ndarray] = None,
) -> None:
    """Write a Bundler v0.3 ``.out`` file (camera_model="bal" problems)."""
    if problem.camera_model != "bal":
        raise ValueError(
            f"save_bundler requires camera_model='bal', got {problem.camera_model!r}"
        )
    R, t, intr, X = (_host64(x) for x in (problem.R, problem.t, problem.intr, problem.X))
    obs_cam = problem.obs_cam.cpu().numpy()
    obs_pt = problem.obs_pt.cpu().numpy()
    uv = _host64(problem.obs_uv)
    n_cam, n_pt, n_obs = R.shape[0], X.shape[0], obs_cam.shape[0]
    if colors is None:
        colors = np.full((n_pt, 3), 255, np.uint8)
    if keys is None:
        keys = np.arange(n_obs, dtype=np.int32)

    # Group observations per point (a problem's are point-sorted, but the
    # writer does not rely on it).
    order = np.argsort(obs_pt, kind="stable")
    starts = np.searchsorted(obs_pt[order], np.arange(n_pt + 1))

    with open(path, "w") as f:
        f.write("# Bundle file v0.3\n")
        f.write(f"{n_cam} {n_pt}\n")
        for c in range(n_cam):
            f.write(f"{intr[c,0]:.17g} {intr[c,1]:.17g} {intr[c,2]:.17g}\n")
            for row in R[c]:
                f.write(f"{row[0]:.17g} {row[1]:.17g} {row[2]:.17g}\n")
            f.write(f"{t[c,0]:.17g} {t[c,1]:.17g} {t[c,2]:.17g}\n")
        for p in range(n_pt):
            f.write(f"{X[p,0]:.17g} {X[p,1]:.17g} {X[p,2]:.17g}\n")
            f.write(f"{colors[p,0]} {colors[p,1]} {colors[p,2]}\n")
            rows = order[starts[p]:starts[p + 1]]
            parts = [str(len(rows))]
            for m in rows:
                parts += [
                    str(int(obs_cam[m])), str(int(keys[m])),
                    f"{uv[m,0]:.17g}", f"{uv[m,1]:.17g}",
                ]
            f.write(" ".join(parts) + "\n")
