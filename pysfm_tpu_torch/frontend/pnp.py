"""Perspective-n-Point resection: camera pose from 2D-3D correspondences.

Port of :mod:`pysfm_tpu.frontend.pnp`: a weighted DLT for the [R|t]
projective estimate (normalized coordinates), orthogonal Procrustes onto
SO(3), cheirality disambiguation, then a fixed number of damped
Gauss-Newton steps on the 6-DoF pose.  Every function broadcasts over
leading batch dimensions (RANSAC hypotheses, frames).
"""

from __future__ import annotations

from typing import Tuple

import torch

from pysfm_tpu_torch.frontend.ransac import ransac
from pysfm_tpu_torch.geometry import so3
from pysfm_tpu_torch.utils import precision as xp


def proper_rotation(M: torch.Tensor) -> torch.Tensor:
    """Nearest proper rotation to ``M [..., 3, 3]`` (Procrustes): U diag(1,
    1, det(U Vt)) Vt from the SVD, which the SVD's sign freedom leaves
    unchanged."""
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(xp.matmul(U, Vt))
    fix = torch.cat([torch.ones_like(U[..., 0, :2]), det[..., None]], dim=-1)
    return xp.matmul(U * fix[..., None, :], Vt)


def pnp_dlt(
    X: torch.Tensor,     # [..., N, 3] world points
    pn: torch.Tensor,    # [..., N, 2] normalized image coords (pinhole convention)
    w: torch.Tensor,     # [..., N] weights (>= 6 effective points)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted DLT: returns (R [..., 3, 3], t [..., 3]) with p_cam = R X + t.

    Solves min ||A vec(P)|| over P = [R|t] up to scale from
    ``xn (P3 . Xh) - (P1 . Xh) = 0`` style constraints, then projects onto
    SO(3) (Procrustes) and fixes scale and sign by cheirality.
    """
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)   # [..., N, 4]
    zero = torch.zeros_like(Xh)
    xn, yn = pn[..., 0:1], pn[..., 1:2]
    # Rows: [Xh, 0, -xn*Xh] and [0, Xh, -yn*Xh] over vec(P) (row-major P).
    A1 = torch.cat([Xh, zero, -xn * Xh], dim=-1)                # [..., N, 12]
    A2 = torch.cat([zero, Xh, -yn * Xh], dim=-1)
    A = torch.cat([A1, A2], dim=-2)                             # [..., 2N, 12]
    ww = torch.cat([w, w], dim=-1)
    M = xp.matmul((A * ww[..., None]).transpose(-1, -2), A)     # [..., 12, 12]
    _, V = torch.linalg.eigh(M)
    P = V[..., :, 0].reshape(*V.shape[:-2], 3, 4)
    # Fix the sign BEFORE the SO(3) projection (-R is not a rotation): the
    # projective depths P3 . Xh_i must be majority-positive.  eigh's sign
    # is arbitrary, and this makes the result independent of it.
    wdepth = xp.matvec(Xh, P[..., 2, :])
    pos = torch.sum((wdepth > 0) * w, dim=-1)
    neg = torch.sum((wdepth < 0) * w, dim=-1)
    P = P * torch.where(pos >= neg, 1.0, -1.0).to(P.dtype)[..., None, None]
    # Fix the scale: the third row of the rotation part has unit norm.
    P = P / torch.clamp(torch.linalg.norm(P[..., 2, :3], dim=-1), min=1e-12)[..., None, None]
    return proper_rotation(P[..., :3]), P[..., 3]


def refine_pose(
    R0: torch.Tensor, t0: torch.Tensor,
    X: torch.Tensor, pn: torch.Tensor, w: torch.Tensor,
    iters: int = 8,
    damping: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-iteration damped GN on the 6-DoF pose, normalized coords.

    Residual per point: pn_hat - pn with pn_hat = (p_xy / p_z), p = R X + t;
    analytic Jacobian with respect to (dw, dt).  ``R0 [..., 3, 3]``,
    ``X [..., N, 3]``.
    """
    R, t = R0, t0
    eye = torch.eye(6, dtype=R0.dtype, device=R0.device)
    for _ in range(iters):
        p = xp.matmul(X, R.transpose(-1, -2)) + t[..., None, :]
        inv_z = 1.0 / p[..., 2]
        pn_hat = p[..., :2] * inv_z[..., None]
        r = pn_hat - pn                                         # [..., N, 2]
        zero = torch.zeros_like(inv_z)
        duv_dp = torch.stack([
            torch.stack([inv_z, zero, -p[..., 0] * inv_z * inv_z], dim=-1),
            torch.stack([zero, inv_z, -p[..., 1] * inv_z * inv_z], dim=-1),
        ], dim=-2)                                              # [..., N, 2, 3]
        RX = p - t[..., None, :]
        J_w = xp.matmul(duv_dp, -so3.hat(RX))                   # [..., N, 2, 3]
        J = torch.cat([J_w, duv_dp], dim=-1)                    # [..., N, 2, 6]
        Jw = J * w[..., None, None]
        H = xp.einsum("...nic,...nid->...cd", Jw, J)
        g = xp.einsum("...nic,...ni->...c", Jw, r)
        hmax = torch.clamp(torch.amax(torch.diagonal(H, dim1=-2, dim2=-1), dim=-1), min=1.0)
        H = H + damping * eye * hmax[..., None, None]
        d = -torch.linalg.solve(H, g)
        R, t = xp.matmul(so3.exp(d[..., :3]), R), t + d[..., 3:]
    return R, t


def pnp(
    X: torch.Tensor, pn: torch.Tensor, w: torch.Tensor | None = None,
    refine_iters: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DLT + GN refinement. Returns (R, t)."""
    if w is None:
        w = torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device)
    R0, t0 = pnp_dlt(X, pn, w)
    return refine_pose(R0, t0, X, pn, w, iters=refine_iters)


def pnp_ransac(
    rng: torch.Generator | torch.Tensor,
    X: torch.Tensor, pn: torch.Tensor,
    *,
    n_hypotheses: int = 128,
    threshold: float = 1e-4,     # squared normalized-coord residual
    sample_size: int = 6,
    data_weights: torch.Tensor | None = None,
):
    """RANSAC'd resection with the DLT as the minimal solver.  ``rng`` is a
    ``torch.Generator`` or the sample indices ``[n_hypotheses,
    sample_size]`` (see :func:`ransac.ransac`).  Returns (R, t, inliers)."""

    def fit(idx, w):
        R, t = pnp_dlt(X, pn, w)
        return torch.cat([R.flatten(-2), t], dim=-1)

    def score(model):
        R = model[..., :9].unflatten(-1, (3, 3))
        t = model[..., 9:]
        p = xp.matmul(X, R.transpose(-1, -2)) + t[..., None, :]
        pn_hat = p[..., :2] / p[..., 2:3]
        d = torch.sum((pn_hat - pn) ** 2, dim=-1)
        # Large-but-finite so a model is not discarded outright when a few
        # (outlier) points land behind the camera.
        return torch.where(p[..., 2] <= 0, torch.full_like(d, 1e10), d)

    res = ransac(
        rng, X.shape[0], fit, score,
        sample_size=sample_size, n_hypotheses=n_hypotheses,
        threshold=threshold, data_weights=data_weights,
    )
    R = res.model[:9].reshape(3, 3)
    t = res.model[9:]
    R, t = refine_pose(R, t, X, pn, res.inliers.to(X.dtype))
    return R, t, res.inliers
