"""Projection models with closed-form (analytic) Jacobians, batched.

Port of :mod:`pysfm_tpu.geometry.projection`.  Camera models:

- ``"pose"``   — 6-DoF pose, fixed K (intr = [fx, fy, cx, cy]).
- ``"pose_k"`` — 6-DoF pose + [fx, fy, cx, cy] optimized (CP = 10).
- ``"bal"``    — BAL convention: 6-DoF pose + [f, k1, k2] with the -p/z
                 flip and radial distortion (CP = 9).

Tangent layout is always ``[dw(3), dt(3), dintr(0|3|4)]``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pysfm_tpu_torch.utils import precision as xp

CAMERA_MODELS = ("pose", "pose_k", "bal")

# Number of intrinsic parameters *stored* per model.
INTR_DIM = {"pose": 4, "pose_k": 4, "bal": 3}
# Tangent (optimized) dim per camera.
CAM_DOF = {"pose": 6, "pose_k": 10, "bal": 9}


def pr(x: torch.Tensor) -> torch.Tensor:
    """Dehomogenize: ``[..., n] -> [..., n-1]`` (the reference's ``pr()``)."""
    return x[..., :-1] / x[..., -1:]


def unpr(x: torch.Tensor) -> torch.Tensor:
    """Homogenize: ``[..., n] -> [..., n+1]`` (the reference's ``unpr()``)."""
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _cam_point(R, t, X):
    return xp.matvec(R, X) + t


def _check_model(model: str) -> None:
    if model not in CAMERA_MODELS:
        raise ValueError(
            f"unknown camera model {model!r}; expected one of {CAMERA_MODELS}"
        )


def project(model: str, R, t, intr, X) -> torch.Tensor:
    """Project world point(s) X to pixel coordinates. Broadcasts."""
    _check_model(model)
    p = _cam_point(R, t, X)
    if model == "bal":
        # BAL: p' = -p/z ; radial rho = 1 + k1 r^2 + k2 r^4 ; uv = f * rho * p'
        f, k1, k2 = intr[..., 0], intr[..., 1], intr[..., 2]
        pn = -p[..., :2] / p[..., 2:3]
        r2 = torch.sum(pn * pn, dim=-1)
        rho = 1.0 + r2 * (k1 + r2 * k2)
        return (f * rho)[..., None] * pn
    fx, fy, cx, cy = intr[..., 0], intr[..., 1], intr[..., 2], intr[..., 3]
    pn = p[..., :2] / p[..., 2:3]
    return torch.stack([fx * pn[..., 0] + cx, fy * pn[..., 1] + cy], dim=-1)


def project_with_jac(
    model: str, R, t, intr, X
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Projection + analytic Jacobians.

    Returns ``(uv [..., 2], J_cam [..., 2, CAM_DOF[model]], J_pt [..., 2, 3])``.
    With p = R X + t and a left perturbation of R:
    dp/ddw = -hat(p - t), dp/ddt = I, dp/dX = R; the pixel map then
    chain-rules through the normalized coordinates.
    """
    _check_model(model)
    p = _cam_point(R, t, X)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    inv_z = 1.0 / z
    zero = torch.zeros_like(inv_z)

    if model == "bal":
        f, k1, k2 = intr[..., 0], intr[..., 1], intr[..., 2]
        pn = -p[..., :2] * inv_z[..., None]
        r2 = torch.sum(pn * pn, dim=-1)
        rho = 1.0 + r2 * (k1 + r2 * k2)
        uv = (f * rho)[..., None] * pn
        # d pn / d p : [-1/z, 0, x/z^2; 0, -1/z, y/z^2]
        dpn_dp = torch.stack(
            [
                torch.stack([-inv_z, zero, x * inv_z * inv_z], dim=-1),
                torch.stack([zero, -inv_z, y * inv_z * inv_z], dim=-1),
            ],
            dim=-2,
        )
        # d uv / d pn = f * (rho I + pn drho^T), drho = (2 k1 + 4 k2 r2) pn
        drho = (2.0 * k1 + 4.0 * k2 * r2)[..., None] * pn
        eye2 = torch.eye(2, dtype=p.dtype, device=p.device)
        duv_dpn = f[..., None, None] * (
            rho[..., None, None] * eye2 + pn[..., :, None] * drho[..., None, :]
        )
        duv_dp = xp.matmul(duv_dpn, dpn_dp)                         # [..., 2, 3]
        J_intr = torch.stack(
            [
                rho[..., None] * pn,                                # d/df
                (f * r2)[..., None] * pn,                           # d/dk1
                (f * r2 * r2)[..., None] * pn,                      # d/dk2
            ],
            dim=-1,
        )                                                           # [..., 2, 3]
    else:
        fx, fy, cx, cy = intr[..., 0], intr[..., 1], intr[..., 2], intr[..., 3]
        pn = p[..., :2] * inv_z[..., None]
        uv = torch.stack([fx * pn[..., 0] + cx, fy * pn[..., 1] + cy], dim=-1)
        duv_dp = torch.stack(
            [
                fx[..., None] * torch.stack([inv_z, zero, -x * inv_z * inv_z], dim=-1),
                fy[..., None] * torch.stack([zero, inv_z, -y * inv_z * inv_z], dim=-1),
            ],
            dim=-2,
        )                                                           # [..., 2, 3]
        if model == "pose_k":
            one = torch.ones_like(inv_z)
            J_intr = torch.stack(
                [
                    torch.stack([pn[..., 0], zero], dim=-1),        # d/dfx
                    torch.stack([zero, pn[..., 1]], dim=-1),        # d/dfy
                    torch.stack([one, zero], dim=-1),               # d/dcx
                    torch.stack([zero, one], dim=-1),               # d/dcy
                ],
                dim=-1,
            )                                                       # [..., 2, 4]
        else:
            J_intr = None

    # Pose blocks via the chain rule through p:  -hat(R X)
    q = p - t
    qx, qy, qz = q[..., 0], q[..., 1], q[..., 2]
    neg_hat_RX = torch.stack(
        [
            torch.stack([zero, qz, -qy], dim=-1),
            torch.stack([-qz, zero, qx], dim=-1),
            torch.stack([qy, -qx, zero], dim=-1),
        ],
        dim=-2,
    )
    J_w = xp.matmul(duv_dp, neg_hat_RX)                             # [..., 2, 3]
    J_pt = xp.matmul(duv_dp, R)                                     # [..., 2, 3]
    blocks = [J_w, duv_dp] if J_intr is None else [J_w, duv_dp, J_intr]
    return uv, torch.cat(blocks, dim=-1), J_pt
