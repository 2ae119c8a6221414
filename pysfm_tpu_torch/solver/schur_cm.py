"""Component-major normal equations + Schur reduction.

Port of :mod:`pysfm_tpu.solver.schur_cm`.  Every per-observation quantity
is a component-major row, a ``[D, M]`` tensor with observations on the
minor axis, and the big contractions are plain 2-D / batched matmuls:

- camera-side reduction: ``[R, M] @ [M, C]`` one-hot matmul.  It is kept
  deterministic on purpose: ``index_add_`` on CUDA uses float atomics and
  breaks run-to-run equality;
- point-side reduction: one row gather through the padded ``pt_obs`` table
  and a K-axis sum;
- Schur outer product: ``S = -Vr^T Vr`` with ``Vr [3P, C*CP]``.

The math is whitened elimination: damped ``Hpp = L L^T``, ``M = L^{-1}``,
``V = W M^T``, ``S = blockdiag(Hcc_aug) - V V^T``.

Layout conventions:

- ``Jct [2*CP, M]``: row ``i*CP + d`` is d(residual_i)/d(cam tangent d).
- ``Jpt [6, M]``: row ``i*3 + s``.
- ``hpp6 / m6 [6, P]``: lower-triangular components (00, 10, 11, 20, 21, 22).
- ``Vr [(p*3+s), (d*C+c)]``: the (d, c) column permutation is the natural
  output order of the batched assembly; the reduced system is permuted back
  to the standard (c, d) order just before the dense solve.

Distributed (``group``, the JAX functions' ``axis_name``): as in
:mod:`~pysfm_tpu_torch.solver.schur`, ``eqs`` arrives with the summed
camera partials (:func:`schur.sum_cameras`) and the functions sum over the
ranks only what they derive from the rank's points.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from pysfm_tpu_torch.solver import schur
from pysfm_tpu_torch.utils import precision as xp
from pysfm_tpu_torch.utils.collectives import pmax, psum, psum_many


class NormalEqsCM(NamedTuple):
    Hcc: torch.Tensor    # [C, CP, CP] (dense, symmetric)
    g_c: torch.Tensor    # [C, CP]
    hpp6: torch.Tensor   # [6, P] lower-tri point blocks
    g_p: torch.Tensor    # [3, P]
    Bg: torch.Tensor     # [P, K, 3*CP] s-major coupling blocks, point grid


def build_normal_equations_cm(
    rt: torch.Tensor,           # [2, M]
    Jct: torch.Tensor,          # [2*CP, M]
    Jpt: torch.Tensor,          # [6, M]
    wt: torch.Tensor,           # [M]
    obs_cam: torch.Tensor,      # [M]
    pt_obs: torch.Tensor,       # [P, K]
    pt_obs_mask: torch.Tensor,  # [P, K]
    n_cameras: int,
) -> NormalEqsCM:
    """J^T W J and J^T W r blockwise, all in component-major layout."""
    cp = Jct.shape[0] // 2
    C = n_cameras
    w = wt[None, :]
    wr0 = rt[0:1] * w
    wr1 = rt[1:2] * w

    # Camera-side rows -> one [rows, M] @ [M, C] matmul.
    # rows: g_c (CP), Hcc lower triangle (CP*(CP+1)/2).  Each row family is
    # one batched expression (a handful of launches, not one per row).
    J0, J1 = Jct[:cp], Jct[cp:]
    # tril_indices lists the lower triangle row by row, (0,0), (1,0), (1,1),
    # (2,0), ... (the hpp6 order for 3x3), and is made on the device.
    d_idx, e_idx = torch.tril_indices(cp, cp, device=Jct.device)
    cam_rows = torch.cat([
        J0 * wr0 + J1 * wr1,
        (J0[d_idx] * J0[e_idx] + J1[d_idx] * J1[e_idx]) * w,
    ])                                                           # [R, M]
    onehot = (
        obs_cam[:, None] == torch.arange(C, dtype=obs_cam.dtype, device=obs_cam.device)
    ).to(Jct.dtype)                                              # [M, C]
    red = xp.matmul(cam_rows, onehot)                            # [R, C]
    g_c = red[:cp].T                                             # [C, CP]
    Hcc = torch.zeros((C, cp, cp), dtype=Jct.dtype, device=Jct.device)
    tri_vals = red[cp:].T                                        # [C, ntri]
    Hcc[:, d_idx, e_idx] = tri_vals
    Hcc[:, e_idx, d_idx] = tri_vals

    # Point-side rows + coupling blocks -> ONE row gather through pt_obs;
    # the coupling blocks stay resident in the point grid for the Schur
    # assembly.
    maskf = pt_obs_mask.to(Jct.dtype)                            # [P, K]
    P0, P1 = Jpt[:3], Jpt[3:]
    a_idx, b_idx = torch.tril_indices(3, 3, device=Jpt.device)
    prows = [
        (P0[a_idx] * P0[b_idx] + P1[a_idx] * P1[b_idx]) * w,     # Hpp (6)
        P0 * wr0 + P1 * wr1,                                     # g_p (3)
        # Coupling rows, s-major: B[s*CP+d] = sum_i Jc[i,d] w Jp[i,s].
        (J0 * (P0[:, None] * w) + J1 * (P1[:, None] * w)).reshape(3 * cp, -1),
    ]
    stacked = torch.cat(prows, dim=0).T                          # [M, 9+3CP]
    grid = stacked[pt_obs] * maskf[..., None]                    # [P, K, 9+3CP]
    red_p = torch.sum(grid[..., :9], dim=1).T                    # [9, P]
    return NormalEqsCM(
        Hcc=Hcc, g_c=g_c, hpp6=red_p[:6], g_p=red_p[6:], Bg=grid[..., 9:]
    )


def _augment6(hpp6: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """LM damping of the lower-tri point blocks, with unit fill on zero
    diagonals (padding / unobserved points) — matches
    schur.augment_block_diag."""

    def aug(d):
        return d + lam * d + torch.where(d == 0, torch.ones_like(d), torch.zeros_like(d))

    return torch.stack(
        [aug(hpp6[0]), hpp6[1], aug(hpp6[2]), hpp6[3], hpp6[4], aug(hpp6[5])]
    )


def _chol6(h6: torch.Tensor) -> torch.Tensor:
    """Closed-form Cholesky of SPD 3x3 blocks in 6-component form."""
    a00, a10, a11, a20, a21, a22 = h6
    l00 = torch.sqrt(a00)
    l10 = a10 / l00
    l20 = a20 / l00
    l11 = torch.sqrt(a11 - l10 * l10)
    l21 = (a21 - l20 * l10) / l11
    l22 = torch.sqrt(a22 - l20 * l20 - l21 * l21)
    return torch.stack([l00, l10, l11, l20, l21, l22])


def _inv_lower6(l6: torch.Tensor) -> torch.Tensor:
    l00, l10, l11, l20, l21, l22 = l6
    m00 = 1.0 / l00
    m11 = 1.0 / l11
    m22 = 1.0 / l22
    m10 = -l10 * m00 * m11
    m21 = -l21 * m11 * m22
    m20 = -(l20 * m00 + l21 * m10) * m22
    return torch.stack([m00, m10, m11, m20, m21, m22])


class SchurSystemCM(NamedTuple):
    S: torch.Tensor     # [A, A] standard (c*CP+d) order, damped
    rhs: torch.Tensor   # [A]
    m6: torch.Tensor    # [6, P]
    Vr: torch.Tensor    # [3P, CP*C]  rows (p*3+s), cols (d*C+c)
    u: torch.Tensor     # [3, P] whitened point gradient


def reduce_cm(
    eqs: NormalEqsCM,
    lam: torch.Tensor,
    obs_pt: torch.Tensor,
    pt_obs: torch.Tensor,
    pt_obs_mask: torch.Tensor,
    obs_cam: torch.Tensor,
    group=None,
) -> SchurSystemCM:
    """Whitened Schur reduction in component-major layout.

    Under ``group`` (a :class:`~pysfm_tpu_torch.dist.mesh.Mesh`; ``eqs``
    with the summed Hcc / g_c) the partial S and its rhs are summed over the
    ranks; point rows stay on their rank."""
    C, cp, _ = eqs.Hcc.shape
    P = eqs.hpp6.shape[1]
    Hcc_aug = schur.augment_block_diag(eqs.Hcc, lam)

    m6 = _inv_lower6(_chol6(_augment6(eqs.hpp6, lam)))            # [6, P]
    # Whiten the grid-resident coupling blocks: E_s = sum_{s'} B_{s'} M[s,s'],
    # with the per-point M components broadcast over the K track slots.
    B0 = eqs.Bg[..., :cp]                                         # [P, K, CP]
    B1 = eqs.Bg[..., cp : 2 * cp]
    B2 = eqs.Bg[..., 2 * cp :]

    def mrow(i):
        return m6[i][:, None, None]

    Eg = torch.cat(
        [
            B0 * mrow(0),
            B0 * mrow(1) + B1 * mrow(2),
            B0 * mrow(3) + B1 * mrow(4) + B2 * mrow(5),
        ],
        dim=-1,
    )                                                             # [P, K, 3CP]
    camg = obs_cam[pt_obs]
    # No mask on the one-hot: padded slots carry Eg == 0 (Bg was masked in
    # the build), so whatever camera they one-hot into contributes zero.
    OH = (
        camg[..., None] == torch.arange(C, dtype=camg.dtype, device=camg.device)
    ).to(m6.dtype)                                                # [P, K, C]
    # One batched contraction over the track axis; the s-major e index
    # makes [P, 3CP, C] -> [(p*3+s), (d*C+c)] a pure reshape.
    Vr = xp.matmul(Eg.transpose(1, 2), OH).reshape(3 * P, cp * C)

    # Whitened point gradient u = M g_p.
    g0, g1, g2 = eqs.g_p[0], eqs.g_p[1], eqs.g_p[2]
    u = torch.stack([
        m6[0] * g0,
        m6[1] * g0 + m6[2] * g1,
        m6[3] * g0 + m6[4] * g1 + m6[5] * g2,
    ])                                                            # [3, P]
    ur = u.T.reshape(3 * P)                                       # rows (p*3+s)

    S_perm, rhs_perm = psum_many(
        (-xp.matmul(Vr.T, Vr), xp.matvec(Vr.T, ur)), group
    )                                                             # [(d,c),(d',c')]
    # Permute (d, c) -> (c, d) standard order.
    S = (
        S_perm.reshape(cp, C, cp, C)
        .permute(1, 0, 3, 2)
        .reshape(C * cp, C * cp)
    )
    rhs_red = rhs_perm.reshape(cp, C).T.reshape(-1)
    eye_c = torch.eye(C, dtype=S.dtype, device=S.device)
    S = (
        S.reshape(C, cp, C, cp)
        + Hcc_aug[:, :, None, :] * eye_c[:, None, :, None]
    ).reshape(C * cp, C * cp)
    rhs = -eqs.g_c.reshape(-1) + rhs_red
    return SchurSystemCM(S=S, rhs=rhs, m6=m6, Vr=Vr, u=u)


def back_substitute_cm(system: SchurSystemCM, dc: torch.Tensor) -> torch.Tensor:
    """dp = -M^T (u + V^T dc); returns [3, P] component-major."""
    dc_perm = dc.T.reshape(-1)                                    # [(d,c)]
    Vt = xp.matvec(system.Vr, dc_perm).reshape(-1, 3).T           # [3, P]
    x0 = system.u[0] + Vt[0]
    x1 = system.u[1] + Vt[1]
    x2 = system.u[2] + Vt[2]
    m = system.m6
    return -torch.stack([
        m[0] * x0 + m[1] * x1 + m[3] * x2,
        m[2] * x1 + m[4] * x2,
        m[5] * x2,
    ])


def solve_step_cm(
    eqs: NormalEqsCM,
    lam: torch.Tensor,
    obs_cam: torch.Tensor,
    obs_pt: torch.Tensor,
    pt_obs: torch.Tensor,
    pt_obs_mask: torch.Tensor,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One damped GN step: returns (dc [C, CP], dp [P, 3])."""
    C, cp, _ = eqs.Hcc.shape
    system = reduce_cm(eqs, lam, obs_pt, pt_obs, pt_obs_mask, obs_cam, group=group)
    Ssym = 0.5 * (system.S + system.S.T)
    L = schur._cholesky_nan(Ssym)
    dc = torch.cholesky_solve(system.rhs[:, None], L).reshape(C, cp)
    dp = back_substitute_cm(system, dc)
    return dc, dp.T


def predicted_reduction_cm(
    eqs: NormalEqsCM,
    lam: torch.Tensor,
    dc: torch.Tensor,
    dp: torch.Tensor,
    group=None,
) -> torch.Tensor:
    """The LM model reduction of the step (dc, dp); under ``group`` (``eqs``
    with the summed Hcc / g_c) the point terms are summed over the ranks."""
    d_cc = torch.diagonal(eqs.Hcc, dim1=-2, dim2=-1)
    d_pp = torch.stack([eqs.hpp6[0], eqs.hpp6[2], eqs.hpp6[5]], dim=-1)  # [P,3]
    fill_c = (d_cc == 0).to(d_cc.dtype)
    fill_p = (d_pp == 0).to(d_pp.dtype)
    cam_term = torch.sum((lam * d_cc + fill_c) * dc * dc) - torch.sum(dc * eqs.g_c)
    pt_term = torch.sum((lam * d_pp + fill_p) * dp * dp) - torch.sum(dp * eqs.g_p.T)
    return 0.5 * (cam_term + psum(pt_term, group))


def grad_inf_cm(eqs, group=None) -> torch.Tensor:
    """Infinity norm of the gradient of any of the solver's normal-equation
    tuples (the layout of g_c and g_p does not matter); under ``group``
    (``eqs`` with the summed g_c) the maximum over every rank's points."""
    return pmax(
        torch.maximum(torch.max(torch.abs(eqs.g_c)), torch.max(torch.abs(eqs.g_p))), group
    )
