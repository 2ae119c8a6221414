"""Block normal equations + Schur-complement reduction, standard layout.

Port of :mod:`pysfm_tpu.solver.schur`: build the block-sparse normal
equations (per-camera blocks Hcc, per-point 3x3 blocks Hpp, per-observation
coupling blocks B), damp the block diagonals, eliminate the points through
the Schur complement ``S = Hcc - Hcp Hpp^-1 Hcp^T``, solve the reduced
camera system with a dense Cholesky and back-substitute the point steps.

- Per-observation blocks come from one batched expression; the block sums
  either use the padded visibility tables (camera side: one ``[M, C]``
  one-hot matmul; point side: a gather through ``pt_obs`` and a sum over
  the track axis) or, without tables, ``index_add_`` segment sums.
- Hpp is factored in closed form (batched 3x3 Cholesky, no LAPACK).
- The whitened coupling operand ``V [P, C*CP, 3]`` is dense: this is the
  small/medium-C regime (``solver="pcg"`` is the matrix-free route).
- Zero diagonal entries (gauge-fixed cameras, unobserved points) get a
  unit fill so every factorization exists; their gradients are zero, so
  their steps are exactly zero.

Sign conventions: ``g = J^T W r`` and the Newton system is
``[Hcc Hcp; Hcp^T Hpp] [dc; dp] = -[gc; gp]``.

Distributed (``group``, a :class:`~pysfm_tpu_torch.dist.mesh.Mesh`, where
the JAX functions take ``axis_name``): points and their observations are
this rank's shard and the cameras are replicated.  The LM loop sums the
camera partials Hcc and g_c once per linearization (:func:`sum_cameras`);
the functions below take those sums and add over the ranks only what they
derive from the rank's points.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from pysfm_tpu_torch.utils import precision as xp
from pysfm_tpu_torch.utils.collectives import psum, psum_many


class NormalEqs(NamedTuple):
    """Undamped block normal equations + per-observation coupling blocks."""

    Hcc: torch.Tensor   # [C, CP, CP]
    Hpp: torch.Tensor   # [P, 3, 3]
    g_c: torch.Tensor   # [C, CP]
    g_p: torch.Tensor   # [P, 3]
    B: torch.Tensor     # [M, CP, 3]  per-obs Jc^T W Jp (Hcp blocks)


def _segment_sum(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n,) + x.shape[1:], dtype=x.dtype, device=x.device)
    return out.index_add_(0, ids, x)


def build_normal_equations(
    r: torch.Tensor,
    J_cam: torch.Tensor,
    J_pt: torch.Tensor,
    w: torch.Tensor,
    obs_cam: torch.Tensor,
    obs_pt: torch.Tensor,
    n_cameras: int,
    n_points: int,
    pt_obs: Optional[torch.Tensor] = None,
    pt_obs_mask: Optional[torch.Tensor] = None,
) -> NormalEqs:
    """Accumulate J^T W J and J^T W r blockwise.

    With the padded per-point table (``pt_obs``/``pt_obs_mask``) the camera
    sums are one ``[C, M] @ [M, D]`` one-hot matmul and the point sums a
    gather through the table: fixed order, deterministic on the card.
    Without it, ``index_add_`` segment sums (float atomics on CUDA)."""
    wJc = J_cam * w[:, None, None]
    wJp = J_pt * w[:, None, None]
    wr = r * w[:, None]
    b_m = xp.einsum("mic,mip->mcp", J_cam, wJp)
    cp = J_cam.shape[2]

    if pt_obs is not None:
        M = J_cam.shape[0]
        onehot = (
            obs_cam[:, None]
            == torch.arange(n_cameras, dtype=obs_cam.dtype, device=obs_cam.device)
        ).to(J_cam.dtype)                                        # [M, C]
        hcc_m = xp.einsum("mic,mid->mcd", J_cam, wJc).reshape(M, -1)
        gc_m = xp.einsum("mic,mi->mc", J_cam, wr)
        Hcc = xp.matmul(onehot.T, hcc_m).reshape(n_cameras, cp, cp)
        g_c = xp.matmul(onehot.T, gc_m)

        pmask = pt_obs_mask.to(J_pt.dtype)
        Jp_g = J_pt[pt_obs]                                      # [P, K, 2, 3]
        wJp_g = wJp[pt_obs] * pmask[..., None, None]
        wr_pg = wr[pt_obs] * pmask[..., None]
        Hpp = xp.einsum("fkia,fkib->fab", Jp_g, wJp_g)
        g_p = xp.einsum("fkia,fki->fa", Jp_g, wr_pg)
    else:
        hcc_m = xp.einsum("mic,mid->mcd", J_cam, wJc)
        hpp_m = xp.einsum("mip,miq->mpq", J_pt, wJp)
        gc_m = xp.einsum("mic,mi->mc", J_cam, wr)
        gp_m = xp.einsum("mip,mi->mp", J_pt, wr)
        Hcc = _segment_sum(hcc_m, obs_cam, n_cameras)
        Hpp = _segment_sum(hpp_m, obs_pt, n_points)
        g_c = _segment_sum(gc_m, obs_cam, n_cameras)
        g_p = _segment_sum(gp_m, obs_pt, n_points)
    return NormalEqs(Hcc=Hcc, Hpp=Hpp, g_c=g_c, g_p=g_p, B=b_m)


def sum_cameras(eqs, group=None):
    """``eqs`` (any of the solver's normal-equation tuples) with its camera
    partials Hcc and g_c summed over the ranks of ``group``, in one
    collective; ``eqs`` itself with ``group=None``."""
    if group is None:
        return eqs
    Hcc, g_c = psum_many((eqs.Hcc, eqs.g_c), group)
    return eqs._replace(Hcc=Hcc, g_c=g_c)


def augment_block_diag(H: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """LM damping: H + lam * diag(H), with unit fill on exactly-zero diagonal
    entries (gauge-fixed cameras / unobserved or padding points) so the block
    stays invertible; those blocks have zero gradient, hence zero step."""
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    fill = torch.where(d == 0, torch.ones_like(d), torch.zeros_like(d))
    aug = lam * d + fill
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return H + aug[..., :, None] * eye


def _mat3(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse via the adjugate (no LAPACK)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    inv_det = 1.0 / det
    adj = _mat3([[A00, A01, A02], [A10, A11, A12], [A20, A21, A22]])
    return adj * inv_det[..., None, None]


def chol3x3(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form Cholesky of SPD 3x3 blocks: A = L L^T, L lower."""
    a00, a10, a20 = A[..., 0, 0], A[..., 1, 0], A[..., 2, 0]
    a11, a21, a22 = A[..., 1, 1], A[..., 2, 1], A[..., 2, 2]
    l00 = torch.sqrt(a00)
    l10 = a10 / l00
    l20 = a20 / l00
    l11 = torch.sqrt(a11 - l10 * l10)
    l21 = (a21 - l20 * l10) / l11
    l22 = torch.sqrt(a22 - l20 * l20 - l21 * l21)
    zero = torch.zeros_like(l00)
    return _mat3([[l00, zero, zero], [l10, l11, zero], [l20, l21, l22]])


def inv_lower3x3(L: torch.Tensor) -> torch.Tensor:
    """Batched inverse of lower-triangular 3x3 blocks (elementwise)."""
    l00, l10, l20 = L[..., 0, 0], L[..., 1, 0], L[..., 2, 0]
    l11, l21, l22 = L[..., 1, 1], L[..., 2, 1], L[..., 2, 2]
    m00 = 1.0 / l00
    m11 = 1.0 / l11
    m22 = 1.0 / l22
    m10 = -l10 * m00 * m11
    m21 = -l21 * m11 * m22
    m20 = -(l20 * m00 + l21 * m10) * m22
    zero = torch.zeros_like(m00)
    return _mat3([[m00, zero, zero], [m10, m11, zero], [m20, m21, m22]])


def scatter_coupling_dense(
    B: torch.Tensor,
    obs_cam: torch.Tensor,
    obs_pt: torch.Tensor,
    n_cameras: int,
    n_points: int,
    pt_obs: Optional[torch.Tensor] = None,
    pt_obs_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Assemble the dense per-point coupling operand W [P, C*CP, 3]: W[p] is
    the p-th block column of Hcp, P*C*CP*3 values (the small/medium-C
    regime).  With the padded per-point table it is a batched one-hot
    matmul over the track axis; without it, an ``index_put_`` scatter-add."""
    M, CP, _ = B.shape
    if pt_obs is None:
        W = torch.zeros((n_points, n_cameras, CP, 3), dtype=B.dtype, device=B.device)
        W.index_put_((obs_pt.long(), obs_cam.long()), B, accumulate=True)
        return W.reshape(n_points, n_cameras * CP, 3)
    maskf = pt_obs_mask.to(B.dtype)
    Bg = B[pt_obs] * maskf[..., None, None]                    # [P, K, CP, 3]
    camg = obs_cam[pt_obs]                                     # [P, K]
    onehot = (
        camg[..., None]
        == torch.arange(n_cameras, dtype=camg.dtype, device=camg.device)
    ).to(B.dtype) * maskf[..., None]                           # [P, K, C]
    W = xp.einsum("pkc,pkds->pcds", onehot, Bg)               # [P, C, CP, 3]
    return W.reshape(n_points, n_cameras * CP, 3)


class SchurSystem(NamedTuple):
    S: torch.Tensor     # [C*CP, C*CP] reduced camera matrix (damped)
    rhs: torch.Tensor   # [C*CP]
    M: torch.Tensor     # [P, 3, 3] inverse point-Cholesky: Hpp_inv = M^T M
    V: torch.Tensor     # [P, C*CP, 3] whitened coupling V_p = W_p M_p^T
    u: torch.Tensor     # [P, 3] whitened point gradient u_p = M_p g_p


def reduce_dense(
    eqs: NormalEqs,
    lam: torch.Tensor,
    obs_cam: torch.Tensor,
    obs_pt: torch.Tensor,
    pt_obs: Optional[torch.Tensor] = None,
    pt_obs_mask: Optional[torch.Tensor] = None,
    group=None,
) -> SchurSystem:
    """Whitened Schur reduction, dense-W regime: factor the damped
    ``Hpp = L L^T``, ``M = L^-1``, whiten each coupling block
    ``E_m = B_m M_p^T`` before the scatter, then
    ``S = blockdiag(Hcc_aug) - sum_p V_p V_p^T``.

    Under ``group`` ``eqs`` holds the summed Hcc and g_c
    (:func:`sum_cameras`) and this rank's points: the partial S and its rhs
    are summed over the ranks; point-sized state stays where it is."""
    C, CP, _ = eqs.Hcc.shape
    P = eqs.Hpp.shape[0]
    Hcc_aug = augment_block_diag(eqs.Hcc, lam)
    Hpp_aug = augment_block_diag(eqs.Hpp, lam)

    M3 = inv_lower3x3(chol3x3(Hpp_aug))                          # [P, 3, 3]
    m00 = M3[..., 0, 0][obs_pt][:, None]
    m10 = M3[..., 1, 0][obs_pt][:, None]
    m11 = M3[..., 1, 1][obs_pt][:, None]
    m20 = M3[..., 2, 0][obs_pt][:, None]
    m21 = M3[..., 2, 1][obs_pt][:, None]
    m22 = M3[..., 2, 2][obs_pt][:, None]
    B0, B1, B2 = eqs.B[..., 0], eqs.B[..., 1], eqs.B[..., 2]    # [M, CP]
    # E[., t] = sum_s B[., s] * M[t, s]  (M lower-triangular).
    E = torch.stack(
        [B0 * m00, B0 * m10 + B1 * m11, B0 * m20 + B1 * m21 + B2 * m22], dim=-1
    )                                                            # [M, CP, 3]
    V = scatter_coupling_dense(E, obs_cam, obs_pt, C, P, pt_obs, pt_obs_mask)
    u = xp.matvec(M3, eqs.g_p)                                   # [P, 3]
    S, rhs_red = psum_many(
        (-xp.einsum("pas,pbs->ab", V, V), xp.einsum("pas,ps->a", V, u)), group
    )
    # Add the block-diagonal Hcc without a scatter: view S as [C, CP, C, CP].
    eye_c = torch.eye(C, dtype=S.dtype, device=S.device)
    S = (
        S.reshape(C, CP, C, CP) + Hcc_aug[:, :, None, :] * eye_c[:, None, :, None]
    ).reshape(C * CP, C * CP)
    rhs = -eqs.g_c.reshape(-1) + rhs_red
    return SchurSystem(S=S, rhs=rhs, M=M3, V=V, u=u)


def _cholesky_nan(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN where A (or, for a batch, a block of A)
    is not positive definite.

    ``jax.scipy.linalg.cho_factor`` returns NaN on a non-SPD matrix and the
    LM loop then rejects the step through ``isfinite(new_cost)``;
    ``torch.linalg.cholesky`` raises instead.  ``cholesky_ex`` reports the
    failure in ``info`` without a host sync, and the NaN fill keeps the
    control flow of the reference.
    """
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))


def solve_reduced(system: SchurSystem) -> torch.Tensor:
    """Solve S dc = rhs by a dense Cholesky of the symmetrized S (NaN when
    S is not positive definite, as the reference's ``cho_factor``)."""
    S = 0.5 * (system.S + system.S.T)
    return torch.cholesky_solve(system.rhs[:, None], _cholesky_nan(S))[:, 0]


def back_substitute(system: SchurSystem, dc: torch.Tensor) -> torch.Tensor:
    """dp = -Hpp^-1 (g_p + Hcp^T dc), per point; in the whitened form
    dp = -M^T (u + V^T dc)."""
    Vt_dc = xp.einsum("pas,a->ps", system.V, dc)               # [P, 3]
    return -xp.einsum("pts,pt->ps", system.M, system.u + Vt_dc)


def solve_step_dense(
    eqs: NormalEqs,
    lam: torch.Tensor,
    obs_cam: torch.Tensor,
    obs_pt: torch.Tensor,
    pt_obs: Optional[torch.Tensor] = None,
    pt_obs_mask: Optional[torch.Tensor] = None,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One damped Gauss-Newton step via dense Schur: (dc [C, CP], dp [P, 3]).
    Under ``group`` dc is the same on every rank (S and rhs are summed, so
    every rank solves the same reduced system) and dp is this rank's
    point shard's step."""
    system = reduce_dense(eqs, lam, obs_cam, obs_pt, pt_obs, pt_obs_mask, group=group)
    dc = solve_reduced(system)
    dp = back_substitute(system, dc)
    C, CP, _ = eqs.Hcc.shape
    return dc.reshape(C, CP), dp


def predicted_reduction(
    eqs: NormalEqs,
    lam: torch.Tensor,
    dc: torch.Tensor,
    dp: torch.Tensor,
    group=None,
) -> torch.Tensor:
    """LM model reduction L(0) - L(d) = 0.5 * d^T (lam*D d - g) for the step
    solving (H + lam D) d = -g with Marquardt scaling D = diag(H) (+ fill).
    Under ``group`` (``eqs`` with the summed Hcc / g_c) the point terms are
    summed locally, then over the ranks."""
    d_cc = torch.diagonal(eqs.Hcc, dim1=-2, dim2=-1)
    d_pp = torch.diagonal(eqs.Hpp, dim1=-2, dim2=-1)
    fill_c = (d_cc == 0).to(d_cc.dtype)
    fill_p = (d_pp == 0).to(d_pp.dtype)
    cam_term = torch.sum((lam * d_cc + fill_c) * dc * dc) - torch.sum(dc * eqs.g_c)
    pt_term = torch.sum((lam * d_pp + fill_p) * dp * dp) - torch.sum(dp * eqs.g_p)
    return 0.5 * (cam_term + psum(pt_term, group))
