"""Synthetic ground-truth scene generation.

Port of ``look_at_rotation``, ``SyntheticScene`` and ``make_scene`` from
:mod:`pysfm_tpu.pipeline.synthetic`: random points in a box, cameras on a
ring looking at them, exact projections plus optional noise and outliers,
then a perturbed initial guess.  The numpy generator is drawn from in the
same order as the JAX package, so one seed gives the same scene; the exact
projections are computed in f64 on the host and cast to ``dtype`` by
``make_problem``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pysfm_tpu_torch.geometry import projection, so3
from pysfm_tpu_torch.problem import BundleProblem, make_problem


def look_at_rotation(center: np.ndarray, target: np.ndarray, flip_z: bool) -> np.ndarray:
    """World->camera rotation for a camera at ``center`` looking at ``target``.

    ``flip_z=False``: +z forward (pinhole models).  ``flip_z=True``: -z
    forward (BAL convention).  Rows of R are the camera axes in world
    coordinates.
    """
    fwd = target - center
    fwd = fwd / np.linalg.norm(fwd)
    z = -fwd if flip_z else fwd
    up = np.array([0.0, 1.0, 0.0])
    if abs(np.dot(up, z)) > 0.99:
        up = np.array([1.0, 0.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=0)


@dataclass
class SyntheticScene:
    """Ground truth + a perturbed problem ready for the solver."""

    truth: BundleProblem      # exact parameters, zero-residual measurements
    problem: BundleProblem    # perturbed initial guess (same measurements)
    noise_px: float
    outlier_frac: float


def make_scene(
    n_cameras: int = 2,
    n_points: int = 100,
    *,
    camera_model: str = "pose",
    robust: str = "gaussian",
    robust_scale: float = 1.0,
    noise_px: float = 0.0,
    outlier_frac: float = 0.0,
    outlier_px: float = 50.0,
    perturb_rot: float = 0.02,
    perturb_trans: float = 0.05,
    perturb_point: float = 0.05,
    visibility: float = 1.0,
    radius: float = 10.0,
    seed: int = 0,
    dtype=np.float64,
    device="cpu",
) -> SyntheticScene:
    """Cameras on a ring of ``radius`` looking at a unit-ish point cloud.

    ``visibility`` < 1 drops a random subset of (camera, point) pairs so the
    visibility graph is irregular.  Both problems are placed on ``device``.
    """
    rng = np.random.default_rng(seed)
    flip_z = camera_model == "bal"

    X = rng.uniform(-2.0, 2.0, size=(n_points, 3))
    angles = 2.0 * np.pi * np.arange(n_cameras) / max(n_cameras, 3)
    centers = np.stack(
        [
            radius * np.cos(angles),
            0.5 * rng.normal(size=n_cameras),
            radius * np.sin(angles),
        ],
        axis=-1,
    )
    R = np.stack(
        [look_at_rotation(c, np.zeros(3), flip_z) for c in centers], axis=0
    )
    t = -np.einsum("cij,cj->ci", R, centers)

    if camera_model == "bal":
        intr = np.stack(
            [
                800.0 + 10.0 * rng.normal(size=n_cameras),
                np.full(n_cameras, 1e-4),
                np.full(n_cameras, 1e-7),
            ],
            axis=-1,
        )
    else:
        intr = np.stack(
            [
                np.full(n_cameras, 800.0),
                np.full(n_cameras, 800.0),
                np.full(n_cameras, 320.0),
                np.full(n_cameras, 240.0),
            ],
            axis=-1,
        )

    # All pairs, thinned by `visibility`; every point keeps >= 2 views so it
    # stays constrained.
    cam_idx, pt_idx = np.meshgrid(
        np.arange(n_cameras), np.arange(n_points), indexing="ij"
    )
    cam_idx, pt_idx = cam_idx.ravel(), pt_idx.ravel()
    if visibility < 1.0:
        keep = rng.random(cam_idx.shape[0]) < visibility
        # Force the first two cameras of every point to stay.
        keep |= cam_idx < 2
        cam_idx, pt_idx = cam_idx[keep], pt_idx[keep]

    uv = projection.project(
        camera_model,
        torch.from_numpy(R[cam_idx]),
        torch.from_numpy(t[cam_idx]),
        torch.from_numpy(intr[cam_idx]),
        torch.from_numpy(X[pt_idx]),
    ).numpy()
    if noise_px > 0:
        uv = uv + rng.normal(scale=noise_px, size=uv.shape)
    if outlier_frac > 0:
        n_out = int(outlier_frac * uv.shape[0])
        which = rng.choice(uv.shape[0], size=n_out, replace=False)
        uv[which] += rng.uniform(-outlier_px, outlier_px, size=(n_out, 2))

    common = dict(
        camera_model=camera_model,
        robust=robust,
        robust_scale=robust_scale,
        dtype=dtype,
        device=device,
    )
    truth = make_problem(R, t, intr, X, cam_idx, pt_idx, uv, **common)

    # Perturb everything except the gauge-fixed camera 0.
    dw = rng.normal(scale=perturb_rot, size=(n_cameras, 3))
    dw[0] = 0.0
    dt = rng.normal(scale=perturb_trans, size=(n_cameras, 3))
    dt[0] = 0.0
    R_pert = so3.exp(torch.from_numpy(dw)).numpy() @ R
    t_pert = t + dt
    X_pert = X + rng.normal(scale=perturb_point, size=X.shape)
    problem = make_problem(
        R_pert, t_pert, intr, X_pert, cam_idx, pt_idx, uv, **common
    )
    return SyntheticScene(
        truth=truth, problem=problem, noise_px=noise_px, outlier_frac=outlier_frac
    )
