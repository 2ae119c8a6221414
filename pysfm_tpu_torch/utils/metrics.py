"""Evaluation metrics: trajectory alignment + ATE, reprojection RMSE.

Port of :mod:`pysfm_tpu.utils.metrics`.  ATE is computed after a
similarity (Sim(3)) alignment because monocular SfM is defined only up to
gauge (rotation, translation, scale).
"""

from __future__ import annotations

import torch

from pysfm_tpu_torch.geometry import se3
from pysfm_tpu_torch.utils import precision as xp


def umeyama(src: torch.Tensor, dst: torch.Tensor, with_scale: bool = True):
    """Least-squares similarity transform (s, R, t): dst ~ s R src + t.

    Umeyama (1991); closed form via the SVD of the covariance.  [N, 3] each.
    """
    mu_s = torch.mean(src, dim=0)
    mu_d = torch.mean(dst, dim=0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = xp.matmul(dc.T, sc) / src.shape[0]
    U, D, Vt = torch.linalg.svd(cov)
    sgn = torch.sign(torch.linalg.det(xp.matmul(U, Vt)))
    S = torch.cat([torch.ones(2, dtype=src.dtype, device=src.device), sgn[None]])
    R = xp.matmul(U * S[None, :], Vt)
    if with_scale:
        var_s = torch.mean(torch.sum(sc * sc, dim=-1))
        s = torch.sum(D * S) / torch.clamp(var_s, min=1e-18)
    else:
        s = torch.ones((), dtype=src.dtype, device=src.device)
    t = mu_d - s * xp.matvec(R, mu_s)
    return s, R, t


def ate_rmse(
    traj_est: torch.Tensor, traj_gt: torch.Tensor, with_scale: bool = True
) -> torch.Tensor:
    """Absolute trajectory error (RMSE of camera centers) after Sim(3)
    alignment of the estimate onto the ground truth."""
    s, R, t = umeyama(traj_est, traj_gt, with_scale)
    aligned = s * xp.matmul(traj_est, R.T) + t
    return torch.sqrt(torch.mean(torch.sum((aligned - traj_gt) ** 2, dim=-1)))


def reprojection_rmse(problem) -> float:
    """RMSE (2-norm px) of the active observations of a BundleProblem."""
    from pysfm_tpu_torch.problem import residuals

    r = residuals(problem)
    w = problem.obs_w > 0
    return float(torch.sqrt(torch.mean(torch.sum(r[w] ** 2, dim=-1))))


def camera_centers(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return se3.camera_center(R, t)
