"""Triangulation: batched linear (DLT) and Gauss-Newton refinement.

Port of :mod:`pysfm_tpu.frontend.triangulate`.  Every function broadcasts
over leading batch dimensions where the JAX package vmaps: a point is
solved from the 3x3 normal equations of its cross-product constraints with
the closed-form batched inverse, and unobserved views carry a zero mask.
"""

from __future__ import annotations

import torch

from pysfm_tpu_torch.geometry import projection
from pysfm_tpu_torch.solver.schur import inv3x3
from pysfm_tpu_torch.utils import precision as xp


def pixel_to_normalized(model: str, intr: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixel -> normalized image coordinates (undistorting where the model
    has distortion).  Broadcasts over leading dims.

    For ``bal`` the radial distortion is inverted by fixed-point iteration
    (5 steps), and the result follows the *pinhole* convention
    ``pn = p/z`` with the BAL -z flip folded in, so downstream geometry is
    convention-free.
    """
    projection._check_model(model)
    if model == "bal":
        f, k1, k2 = intr[..., 0], intr[..., 1], intr[..., 2]
        d = uv / f[..., None]          # = rho * pn_bal
        pn = d
        for _ in range(5):
            r2 = torch.sum(pn * pn, dim=-1)
            rho = 1.0 + r2 * (k1 + r2 * k2)
            pn = d / rho[..., None]
        # BAL: pn_bal = -p/z; convert to the pinhole p/z convention.
        return -pn
    fx, fy, cx, cy = intr[..., 0], intr[..., 1], intr[..., 2], intr[..., 3]
    return torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)


def forward_sign(model: str) -> float:
    """Camera-frame depth sign for points in front: +1 pinhole, -1 BAL."""
    return -1.0 if model == "bal" else 1.0


def triangulate_linear(
    R: torch.Tensor,       # [..., V, 3, 3]
    t: torch.Tensor,       # [..., V, 3]
    pn: torch.Tensor,      # [..., V, 2] normalized coords (pinhole convention)
    mask: torch.Tensor,    # [..., V] weights (0/1 or confidences)
) -> torch.Tensor:
    """Linear triangulation of points from masked views: [..., 3].

    Constraints per view (p = R X + t, pn = p_xy / p_z):
    ``(R0 - xn R2) X = -(t0 - xn t2)`` and the same for y, solved through
    the 3x3 normal equations.  Leading dims broadcast (points, candidates).
    """
    xn, yn = pn[..., 0:1], pn[..., 1:2]
    a1 = R[..., 0, :] - xn * R[..., 2, :]                  # [..., V, 3]
    a2 = R[..., 1, :] - yn * R[..., 2, :]
    b1 = -(t[..., 0] - pn[..., 0] * t[..., 2])             # [..., V]
    b2 = -(t[..., 1] - pn[..., 1] * t[..., 2])
    A = torch.cat([a1, a2], dim=-2)                        # [..., 2V, 3]
    b = torch.cat([b1, b2], dim=-1)
    w = torch.cat([mask, mask], dim=-1).to(A.dtype)
    Aw = A * w[..., None]
    AtA = xp.einsum("...vi,...vj->...ij", Aw, A)
    Atb = xp.einsum("...vi,...v->...i", Aw, b)
    # Identity fill keeps unobserved/degenerate systems finite.
    d = torch.diagonal(AtA, dim1=-2, dim2=-1)
    empty = (torch.amax(torch.abs(d), dim=-1) == 0).to(A.dtype)
    AtA = AtA + empty[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    return xp.matvec(inv3x3(AtA), Atb)


def triangulate_points(
    model: str,
    R: torch.Tensor,      # [V, 3, 3] camera poses
    t: torch.Tensor,      # [V, 3]
    intr: torch.Tensor,   # [V, I]
    uv: torch.Tensor,     # [P, V, 2] pixel measurements per point/view
    mask: torch.Tensor,   # [P, V]
) -> torch.Tensor:
    """Batched multi-view triangulation: [P, 3] world points."""
    pn = pixel_to_normalized(model, intr, uv)         # [P, V, 2]
    return triangulate_linear(R, t, pn, mask)


def depths(R: torch.Tensor, t: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Camera-frame z of points. Broadcasts: [..., 3, 3], [..., 3], [..., 3]."""
    return torch.sum(R[..., 2, :] * X, dim=-1) + t[..., 2]


def refine_points(
    model: str,
    R: torch.Tensor, t: torch.Tensor, intr: torch.Tensor,   # [V, ...]
    uv: torch.Tensor, mask: torch.Tensor,                   # [P, V, 2], [P, V]
    X0: torch.Tensor,                                       # [P, 3]
    iters: int = 5,
) -> torch.Tensor:
    """Gauss-Newton polish of triangulated points (point-only BA), batched:
    a fixed number of masked 3x3 solves per point."""
    eye = torch.eye(3, dtype=X0.dtype, device=X0.device)
    m = mask.to(X0.dtype)
    X = X0
    for _ in range(iters):
        uv_hat, _, J_pt = projection.project_with_jac(
            model, R[None], t[None], intr[None], X[:, None, :]
        )
        r = (uv_hat - uv) * m[..., None]                      # [P, V, 2]
        Jm = J_pt * m[..., None, None]
        H = xp.einsum("pvis,pvit->pst", Jm, J_pt)
        g = xp.einsum("pvis,pvi->ps", Jm, r)
        d = torch.diagonal(H, dim1=-2, dim2=-1)
        empty = (torch.amax(torch.abs(d), dim=-1) == 0).to(X.dtype)
        H = H + 1e-8 * eye + eye * empty[:, None, None]
        X = X - xp.matvec(inv3x3(H), g)
    return X
