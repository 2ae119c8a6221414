"""BAL ("Bundle Adjustment in the Large") problem file I/O.

Port of :mod:`pysfm_tpu.io.bal`.  BAL is the text format of the public
large bundle-adjustment datasets (Agarwal et al., ECCV 2010):

    n_cameras n_points n_observations
    cam_idx point_idx u v              # x n_observations
    <9 params per camera>              # 3 Rodrigues, 3 translation, f, k1, k2
    <3 coords per point>

Convention: ``x_cam = R X + t`` with the camera looking down **-z**
(projection ``-p/z``, camera model "bal").  The loader emits the device
layout directly: observations sorted by point, padded visibility tables
built once, ``dtype`` chosen by the caller, tensors on ``device`` (the card
unless the caller asks for the CPU).  ``.gz`` and ``.bz2`` files are read
and written transparently.  Rodrigues vectors become matrices (and back) on
the host in f64, before the cast to ``dtype``.
"""

from __future__ import annotations

import bz2
import gzip
import io as _io
from typing import Optional, Tuple

import numpy as np
import torch

from pysfm_tpu_torch.geometry import so3
from pysfm_tpu_torch.io import native
from pysfm_tpu_torch.problem import BundleProblem, make_problem


def _open(path, mode: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    if str(path).endswith(".bz2"):
        return bz2.open(path, mode)
    return open(path, mode)


def load_bal(
    path,
    *,
    robust: str = "gaussian",
    robust_scale: float = 1.0,
    dtype=np.float64,
    max_track: Optional[int] = None,
    layout: str = "std",
    device="cuda",
):
    """Load a BAL problem file.

    ``layout="std"`` returns a :class:`BundleProblem`; ``layout="cm"``
    returns the component-major :class:`~pysfm_tpu_torch.problem.cm.CMProblem`
    the pcg route consumes directly (``solve(cmp, LMConfig(solver="pcg"),
    gops=make_grouped_ops(cmp))``)."""
    if layout not in ("std", "cm"):
        raise ValueError(f"unknown layout {layout!r}")
    with _open(path, "rb") as f:
        tokens = native.parse_doubles(f.read())
    n_cam, n_pt, n_obs = int(tokens[0]), int(tokens[1]), int(tokens[2])
    k = 3
    obs = tokens[k : k + 4 * n_obs].reshape(n_obs, 4)
    k += 4 * n_obs
    cams = tokens[k : k + 9 * n_cam].reshape(n_cam, 9)
    k += 9 * n_cam
    X = tokens[k : k + 3 * n_pt].reshape(n_pt, 3)

    obs_cam = obs[:, 0].astype(np.int32)
    obs_pt = obs[:, 1].astype(np.int32)
    uv = obs[:, 2:4]
    R = so3.exp(torch.from_numpy(np.ascontiguousarray(cams[:, 0:3]))).numpy()
    t = cams[:, 3:6]
    intr = cams[:, 6:9]                       # f, k1, k2
    kw = dict(
        camera_model="bal", robust=robust, robust_scale=robust_scale,
        dtype=dtype, max_track=max_track, device=device,
    )
    if layout == "cm":
        from pysfm_tpu_torch.problem import cm as cm_mod

        return cm_mod.make_cm_problem(R, t, intr, X, obs_cam, obs_pt, uv, **kw)
    return make_problem(R, t, intr, X, obs_cam, obs_pt, uv, **kw)


def _host64(x: torch.Tensor) -> np.ndarray:
    return x.detach().to("cpu", torch.float64).numpy()


def save_bal(path, problem: BundleProblem) -> None:
    """Write a :class:`BundleProblem` (camera_model="bal") as a BAL file."""
    if problem.camera_model != "bal":
        raise ValueError(
            f"save_bal requires camera_model='bal', got {problem.camera_model!r}"
        )
    R = problem.R.detach().to("cpu", torch.float64)
    w = so3.log(R).numpy()
    t = _host64(problem.t)
    intr = _host64(problem.intr)
    X = _host64(problem.X)
    obs_cam = problem.obs_cam.cpu().numpy()
    obs_pt = problem.obs_pt.cpu().numpy()
    uv = _host64(problem.obs_uv)

    header = f"{R.shape[0]} {X.shape[0]} {obs_cam.shape[0]}\n".encode()
    cams = np.concatenate([w, t, intr], axis=-1)          # [C, 9]
    vals = np.concatenate([cams.reshape(-1), X.reshape(-1)])
    body = native.format_bal(obs_cam, obs_pt, uv, vals)
    if body is None:
        buf = _io.BytesIO()
        obs_block = np.column_stack(
            [obs_cam.astype(np.float64), obs_pt.astype(np.float64), uv]
        )
        np.savetxt(buf, obs_block, fmt="%d %d %.17g %.17g")
        np.savetxt(buf, vals[:, None], fmt="%.17g")
        body = buf.getvalue()
    with _open(path, "wb") as f:
        f.write(header)
        f.write(body)


def make_synthetic_bal(
    n_cameras: int, n_points: int, **kw
) -> Tuple[BundleProblem, BundleProblem]:
    """(truth, perturbed) synthetic problem in BAL convention — the stand-in
    for the BAL datasets where none can be downloaded."""
    from pysfm_tpu_torch.pipeline import synthetic

    sc = synthetic.make_scene(n_cameras, n_points, camera_model="bal", **kw)
    return sc.truth, sc.problem
