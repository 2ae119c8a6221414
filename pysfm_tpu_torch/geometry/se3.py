"""SE(3) — rigid transforms as (R, t) pairs, batched.

Port of :mod:`pysfm_tpu.geometry.se3`.  Camera extrinsics are stored
world-to-camera, ``x_cam = R @ X + t``; LM updates are left perturbations
``R <- exp([dw]x) @ R; t <- t + dt``.
"""

from __future__ import annotations

import torch

from pysfm_tpu_torch.geometry import so3
from pysfm_tpu_torch.utils import precision as xp


def transform(R: torch.Tensor, t: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Apply world->camera transform: [..., 3, 3], [..., 3], [..., 3] -> [..., 3]."""
    return xp.matvec(R, X) + t


def inverse(R: torch.Tensor, t: torch.Tensor):
    """Inverse transform: (R, t) -> (R^T, -R^T t)."""
    Rt = R.transpose(-1, -2)
    return Rt, -xp.matvec(Rt, t)


def compose(Ra, ta, Rb, tb):
    """(Ra, ta) o (Rb, tb): first apply b, then a."""
    return xp.matmul(Ra, Rb), xp.matvec(Ra, tb) + ta


def camera_center(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Camera center in world coordinates: C = -R^T t."""
    return -xp.einsum("...ji,...j->...i", R, t)


def retract(R, t, dw, dt):
    """Left-perturbation 6-DoF update used by the LM solver."""
    return xp.matmul(so3.exp(dw), R), t + dt


def exp(xi: torch.Tensor):
    """SE(3) exponential of twist xi = (w, v): [..., 6] -> (R, t), with the
    closed-form left Jacobian V so that exp is exact."""
    w, v = xi[..., :3], xi[..., 3:]
    theta_sq = torch.sum(w * w, dim=-1)
    R = so3.exp(w)
    a, b = so3._exp_coefs(theta_sq)
    # V = I + B*W + C*W^2 with C = (1 - A)/theta^2 (small-angle safe).
    small = theta_sq < so3._SMALL_SQ
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    c_exact = (1.0 - a) / safe_sq
    c_taylor = 1.0 / 6.0 - theta_sq / 120.0
    c = torch.where(small, c_taylor, c_exact)
    W = so3.hat(w)
    V = (
        torch.eye(3, dtype=xi.dtype, device=xi.device)
        + b[..., None, None] * W
        + c[..., None, None] * xp.matmul(W, W)
    )
    return R, xp.matvec(V, v)
