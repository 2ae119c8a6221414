"""Two-view epipolar geometry: normalized 8-point F/E, pose from E.

Port of :mod:`pysfm_tpu.frontend.epipolar`.  Every function broadcasts
over leading batch dimensions (pairs, RANSAC hypotheses), where the JAX
package vmaps.

Convention: pinhole, x2^T E x1 = 0 with x = (xn, yn, 1) normalized coords;
(R, t) maps camera-1 coordinates to camera-2: p2 = R p1 + t.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from pysfm_tpu_torch.frontend import triangulate as tri
from pysfm_tpu_torch.geometry import so3
from pysfm_tpu_torch.utils import precision as xp


def normalize_points(x: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hartley normalization: translate the centroid to the origin, scale the
    mean distance to sqrt(2).  ``x [..., N, 2]``, ``w [..., N]`` weights;
    returns (xh [..., N, 3] normalized homogeneous, T [..., 3, 3]) with
    xh = T @ [x; 1]."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-12)
    mean = torch.sum(x * w[..., None], dim=-2) / wsum[..., None]        # [..., 2]
    d = torch.sqrt(torch.sum((x - mean[..., None, :]) ** 2, dim=-1))
    scale = math.sqrt(2.0) / torch.clamp(torch.sum(d * w, dim=-1) / wsum, min=1e-12)
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    T = torch.stack([
        torch.stack([scale, zero, -scale * mean[..., 0]], dim=-1),
        torch.stack([zero, scale, -scale * mean[..., 1]], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    xh = xp.matmul(torch.cat([x, torch.ones_like(x[..., :1])], dim=-1), T.transpose(-1, -2))
    return xh, T


def eight_point(
    x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor | None = None,
    essential: bool = False,
) -> torch.Tensor:
    """(Weighted) normalized 8-point algorithm.

    ``x1, x2 [..., N, 2]`` correspondences (8 or more with a positive
    weight), returns F (or E with the (1, 1, 0) singular-value projection)
    such that ``x2h^T F x1h = 0``.  A minimal sample may be passed gathered
    (N = 8): the system gets a zero row, which leaves its null vector as it
    is and keeps the SVD square.
    """
    if w is None:
        w = torch.ones(x1.shape[:-1], dtype=x1.dtype, device=x1.device)
    x1h, T1 = normalize_points(x1, w)
    x2h, T2 = normalize_points(x2, w)
    # A_i = kron(x1h_i, x2h_i): rows of the homogeneous system A f = 0.
    A = (x1h[..., :, None] * x2h[..., None, :]).reshape(*x1h.shape[:-1], 9)
    A = A * w[..., None]
    if A.shape[-2] < 9:
        A = torch.cat([A, A.new_zeros(*A.shape[:-2], 9 - A.shape[-2], 9)], dim=-2)
    # Smallest right singular vector of A: the SVD of the [N, 9] system
    # keeps the error ~eps*cond(A), where eigh of A^T A would square it.
    _, _, Vt = torch.linalg.svd(A, full_matrices=False)
    F = Vt[..., -1, :].reshape(*Vt.shape[:-2], 3, 3).transpose(-1, -2)  # f holds F^T
    # Undo the normalization FIRST (T is not orthogonal, so singular-value
    # projections only make sense in the original frame):
    # x2^T F x1 with xh = T x -> F_orig = T2^T F T1.
    F = xp.matmul(xp.matmul(T2.transpose(-1, -2), F), T1)
    U, s, Vt = torch.linalg.svd(F)
    if essential:
        half = (s[..., 0] + s[..., 1]) / 2.0
        s_proj = torch.stack([half, half, torch.zeros_like(half)], dim=-1)
    else:
        s_proj = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    return xp.matmul(U * s_proj[..., None, :], Vt)


def sampson_distance(F: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) distance squared, [..., N]."""
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    x2h = torch.cat([x2, torch.ones_like(x2[..., :1])], dim=-1)
    Fx1 = xp.matmul(x1h, F.transpose(-1, -2))        # [..., N, 3]
    Ftx2 = xp.matmul(x2h, F)                         # [..., N, 3]
    e = torch.sum(x2h * Fx1, dim=-1)
    denom = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return e * e / torch.clamp(denom, min=1e-12)


def decompose_essential(E: torch.Tensor):
    """E -> 4 candidate (R, t): [..., 4, 3, 3], [..., 4, 3] (|t| = 1).

    The SVD of E is unique only up to signs and a rotation in its repeated
    singular pair, so another LAPACK may return the four candidates in
    another order; :func:`select_pose` picks by cheirality, not by slot.
    """
    U, _, Vt = torch.linalg.svd(E)
    # Keep rotations proper.
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    Ra = xp.matmul(xp.matmul(U, W), Vt)
    Rb = xp.matmul(xp.matmul(U, W.T), Vt)
    tu = U[..., :, 2]
    Rs = torch.stack([Ra, Ra, Rb, Rb], dim=-3)
    ts = torch.stack([tu, -tu, tu, -tu], dim=-2)
    return Rs, ts


def select_pose(
    E: torch.Tensor, pn1: torch.Tensor, pn2: torch.Tensor,
    w: torch.Tensor | None = None,
):
    """Resolve the 4-fold ambiguity by cheirality: triangulate under each
    candidate and pick the one with the most (weighted) points in front of
    both cameras (the first on a tie).  ``E [..., 3, 3]``, ``pn1, pn2
    [..., N, 2]``; returns (R, t, n_good, X [..., N, 3] under the winner)."""
    if w is None:
        w = torch.ones(pn1.shape[:-1], dtype=pn1.dtype, device=pn1.device)
    Rs, ts = decompose_essential(E)                       # [..., 4, 3, 3]
    eye = torch.eye(3, dtype=E.dtype, device=E.device).expand_as(Rs)
    Rpair = torch.stack([eye, Rs], dim=-3)[..., None, :, :, :]   # [..., 4, 1, 2, 3, 3]
    tpair = torch.stack([torch.zeros_like(ts), ts], dim=-2)[..., None, :, :]
    pn = torch.stack([pn1, pn2], dim=-2)[..., None, :, :, :]     # [..., 1, N, 2, 2]
    ones = torch.ones(2, dtype=E.dtype, device=E.device)
    X = tri.triangulate_linear(Rpair, tpair, pn, ones)           # [..., 4, N, 3]
    z1 = tri.depths(torch.eye(3, dtype=E.dtype, device=E.device),
                    torch.zeros(3, dtype=E.dtype, device=E.device), X)
    z2 = tri.depths(Rs[..., None, :, :], ts[..., None, :], X)
    good = (z1 > 0) & (z2 > 0)
    counts = torch.sum(good * w[..., None, :], dim=-1)           # [..., 4]
    k = torch.argmax(counts, dim=-1)[..., None]

    def pick(v, dim):
        idx = k.reshape(*k.shape, *([1] * (-dim - 1)))
        return torch.take_along_dim(v, idx, dim=dim).squeeze(dim)

    return pick(Rs, -3), pick(ts, -2), pick(counts, -1), pick(X, -3)


def essential_from_pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Ground-truth E = [t]x R for tests; p2 = R p1 + t convention."""
    return xp.matmul(so3.hat(t), R)
