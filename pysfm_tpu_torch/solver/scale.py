"""BAL-scale normal equations and cost, component-major: the pcg route's
plain (non-kernel) build.

Port of :mod:`pysfm_tpu.solver.scale`.  This is the route for f64 problems
and for ``gops=None``, and the plain twin of the K_E / K_C kernels
(``solver/kernels/spmv.py``).  Per observation it emits component-major
rows, observations on the minor axis:

- ``B_cm [3*CP, M]``   coupling blocks, row ``s*CP + d`` = B(d, s);
- ``cam_rows [CP(CP+3)/2, M]`` packed ``w Jc^T Jc`` (lower triangle) and
  ``Jc^T w r``;
- ``pt_rows [9, M]``   packed ``w Jp^T Jp`` and ``Jp^T w r``.

Both block reductions run in the gathered (table) domain, as in the JAX
module: one row gather through the padded ``cam_obs`` / ``pt_obsT`` tables
and a masked sum over the track axis, so the summation order is fixed and
the result is deterministic on every device.  ``obs_chunk`` bounds the
Jacobian working set to one chunk (a Python loop over chunks); 0 means
chunks of :data:`OBS_CHUNK_DEFAULT` observations, as the JAX module's code
does (``_chunked``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pysfm_tpu_torch.problem import cm
from pysfm_tpu_torch.problem import robust as robust_mod
from pysfm_tpu_torch.utils.collectives import psum

# Lower-triangular 3x3 component order used throughout (matches schur_cm).
TRI3 = ((0, 0), (1, 0), (1, 1), (2, 0), (2, 1), (2, 2))


class ScaleEqs(NamedTuple):
    """Component-major undamped normal equations for the pcg route.

    ``B_cm is None`` means the coupling rows live only in the kernel
    operands (``GroupedOps.b_rows``, written by the K_E kernel);
    ``pcg.build_pcg_system`` branches on this."""

    Hcc: torch.Tensor    # [C, CP, CP] (dense, symmetric; small)
    g_c: torch.Tensor    # [C, CP]
    hpp6: torch.Tensor   # [6, P] lower-tri point blocks (00,10,11,20,21,22)
    g_p: torch.Tensor    # [3, P]
    B_cm: Optional[torch.Tensor]  # [3*CP, M]; row s*CP+d; None => kernel rows


def _tri_pairs(cp: int):
    return [(d, e) for d in range(cp) for e in range(d + 1)]


def _payload_rows(model, robust, robust_scale, ctab, X3, oc, op, u_o, v_o,
                  w_conf):
    """Component-major per-observation payload of the observations
    ``oc``/``op`` (camera / point ids): ``(B_cm [3*CP, m], cam_rows [Rc, m],
    pt_rows [9, m])`` with ``Rc = CP*(CP+1)/2 + CP`` (Hcc lower triangle,
    then g_c)."""
    cols = ctab[:, oc]                                       # [Dc, m]
    Xg = X3[:, op]                                           # [3, m]
    u, v, Jc, Jp = cm.project_jac_cm(model, cols, Xg)
    r0 = u - u_o
    r1 = v - v_o
    s = r0 * r0 + r1 * r1
    w = w_conf * robust_mod.weight(robust, s, robust_scale)
    cp = len(Jc[0])

    wJp = [[w * Jp[i][k] for k in range(3)] for i in range(2)]
    wr0 = w * r0
    wr1 = w * r1
    B_cm = torch.stack([
        Jc[0][d] * wJp[0][k] + Jc[1][d] * wJp[1][k]
        for k in range(3)
        for d in range(cp)
    ])                                                       # [3*CP, m]
    wJc = [[w * Jc[i][d] for d in range(cp)] for i in range(2)]
    cam_rows = torch.stack(
        [wJc[0][d] * Jc[0][e] + wJc[1][d] * Jc[1][e] for d, e in _tri_pairs(cp)]
        + [Jc[0][d] * wr0 + Jc[1][d] * wr1 for d in range(cp)]
    )                                                        # [Rc, m]
    pt_rows = torch.stack(
        [Jp[0][d] * wJp[0][e] + Jp[1][d] * wJp[1][e] for d, e in TRI3]
        + [Jp[0][k] * wr0 + Jp[1][k] * wr1 for k in range(3)]
    )                                                        # [9, m]
    return B_cm, cam_rows, pt_rows


def _unpack_sym(rows: torch.Tensor, cp: int) -> torch.Tensor:
    """``[N_tri, C]`` packed lower-tri rows -> ``[C, cp, cp]`` symmetric."""
    d_idx, e_idx = torch.tril_indices(cp, cp, device=rows.device)
    out = torch.zeros((rows.shape[1], cp, cp), dtype=rows.dtype, device=rows.device)
    out[:, d_idx, e_idx] = rows.T
    out[:, e_idx, d_idx] = rows.T
    return out


# Observations of one chunk when ``obs_chunk`` is 0 (the JAX module's
# ``min(obs_chunk or (1 << 18), M)``).
OBS_CHUNK_DEFAULT = 1 << 18


def _chunks(M: int, obs_chunk: int):
    """``[(lo, hi)]`` chunks of at most ``obs_chunk`` observations (0: at
    most :data:`OBS_CHUNK_DEFAULT`) covering ``[0, M)`` in order."""
    step = min(obs_chunk or OBS_CHUNK_DEFAULT, M) or 1
    return [(lo, min(lo + step, M)) for lo in range(0, M, step)]


def build_normal_equations_scale_cm(
    cmp: cm.CMProblem, obs_chunk: int = 0
) -> ScaleEqs:
    """Scatter-free component-major normal equations for the pcg route;
    the payload is built one chunk of ``obs_chunk`` observations at a time
    (0: :data:`OBS_CHUNK_DEFAULT`) and the chunks are concatenated before
    they are reduced."""
    cp = cmp.cam_dof
    ctab = cm.cam_table(cmp)                                  # [Dc, C]
    parts = [
        _payload_rows(
            cmp.camera_model, cmp.robust, cmp.robust_scale, ctab, cmp.X3,
            cmp.obs_cam[lo:hi], cmp.obs_pt[lo:hi], cmp.u[lo:hi], cmp.v[lo:hi],
            cmp.obs_w[lo:hi],
        )
        for lo, hi in _chunks(cmp.n_obs, obs_chunk)
    ]
    B_cm, cam_rows, pt_rows = (
        torch.cat([pt[i] for pt in parts], dim=1) for i in range(3)
    )

    # Camera side: gather the rows into the [C, Kc] grid + masked sum.
    cmask = cmp.cam_obs_mask.to(B_cm.dtype)                   # [C, Kc]
    cred = torch.sum(cam_rows[:, cmp.cam_obs] * cmask, dim=-1)  # [Rc, C]
    n_tri = cp * (cp + 1) // 2
    Hcc = _unpack_sym(cred[:n_tri], cp)
    g_c = cred[n_tri:].T.contiguous()                         # [C, CP]

    # Point side through the transposed pt_obs table: [9, K, P] -> [9, P].
    pmask_t = cmp.pt_obs_maskT.to(B_cm.dtype)                 # [K, P]
    pred = torch.sum(pt_rows[:, cmp.pt_obsT] * pmask_t, dim=1)  # [9, P]
    return ScaleEqs(Hcc=Hcc, g_c=g_c, hpp6=pred[:6], g_p=pred[6:], B_cm=B_cm)


def build_normal_equations_scale(p, obs_chunk: int = 0) -> ScaleEqs:
    """Standard-layout entry: converts a BundleProblem to the CM layout (one
    transpose of the point and observation arrays) and delegates to
    :func:`build_normal_equations_scale_cm`."""
    return build_normal_equations_scale_cm(cm.from_problem(p), obs_chunk)


def sym6_inv(h6: torch.Tensor) -> torch.Tensor:
    """Inverse of symmetric 3x3 blocks in 6-component form (``[6, N]``)."""
    a, b, c, d, e, f = h6
    adj00 = c * f - e * e
    adj10 = d * e - b * f
    adj20 = b * e - c * d
    adj11 = a * f - d * d
    adj21 = b * d - a * e
    adj22 = a * c - b * b
    det = a * adj00 + b * adj10 + d * adj20
    inv_det = 1.0 / det
    return torch.stack([adj00, adj10, adj11, adj20, adj21, adj22]) * inv_det


def sym6_mv(h6: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``[6, N]`` symmetric blocks times ``[3, N]`` vectors -> ``[3, N]``."""
    a, b, c, d, e, f = h6
    return torch.stack([
        a * v[0] + b * v[1] + d * v[2],
        b * v[0] + c * v[1] + e * v[2],
        d * v[0] + e * v[1] + f * v[2],
    ])


def augment6(h6: torch.Tensor, lam) -> torch.Tensor:
    """LM damping of lower-tri point blocks with unit fill on zero diagonals
    (padding / unobserved points), as ``schur.augment_block_diag``."""

    def aug(x):
        return x + lam * x + torch.where(x == 0, torch.ones_like(x), torch.zeros_like(x))

    return torch.stack([aug(h6[0]), h6[1], aug(h6[2]), h6[3], h6[4], aug(h6[5])])


def cost_scale_cm(cmp: cm.CMProblem, obs_chunk: int = 0) -> torch.Tensor:
    """Robust cost ``0.5 sum_m w_m rho(|r_m|^2)``, one chunk of
    observations at a time."""
    ctab = cm.cam_table(cmp)
    parts = []
    for lo, hi in _chunks(cmp.n_obs, obs_chunk):
        uh, vh = cm.project_cm(
            cmp.camera_model, ctab[:, cmp.obs_cam[lo:hi]], cmp.X3[:, cmp.obs_pt[lo:hi]]
        )
        r0 = uh - cmp.u[lo:hi]
        r1 = vh - cmp.v[lo:hi]
        s = r0 * r0 + r1 * r1
        parts.append(torch.sum(
            cmp.obs_w[lo:hi] * robust_mod.rho(cmp.robust, s, cmp.robust_scale)
        ))
    return 0.5 * torch.sum(torch.stack(parts))


def cost_scale(p, obs_chunk: int = 0) -> torch.Tensor:
    """Standard-layout entry for :func:`cost_scale_cm`."""
    return cost_scale_cm(cm.from_problem(p), obs_chunk)


def predicted_reduction_scale(
    eqs: ScaleEqs, lam, dc: torch.Tensor, dp: torch.Tensor, group=None
) -> torch.Tensor:
    """:func:`predicted_reduction_scale_cm` for a standard-layout point step
    ``dp [P, 3]``."""
    return predicted_reduction_scale_cm(eqs, lam, dc, dp.T, group)


def predicted_reduction_scale_cm(
    eqs: ScaleEqs, lam, dc: torch.Tensor, dp3: torch.Tensor, group=None
) -> torch.Tensor:
    """The LM model reduction of the step ``(dc [C, CP], dp3 [3, P])``.

    Under ``group`` (a :class:`~pysfm_tpu_torch.dist.mesh.Mesh`) ``eqs``
    holds the summed Hcc / g_c (:func:`schur.sum_cameras`) and this rank's
    point terms, which are summed locally, then over the ranks."""
    d_cc = torch.diagonal(eqs.Hcc, dim1=-2, dim2=-1)
    d_pp3 = torch.stack([eqs.hpp6[0], eqs.hpp6[2], eqs.hpp6[5]])   # [3, P]
    fill_c = (d_cc == 0).to(d_cc.dtype)
    fill_p = (d_pp3 == 0).to(d_pp3.dtype)
    cam_term = torch.sum((lam * d_cc + fill_c) * dc * dc) - torch.sum(dc * eqs.g_c)
    pt_term = torch.sum((lam * d_pp3 + fill_p) * dp3 * dp3) - torch.sum(dp3 * eqs.g_p)
    return 0.5 * (cam_term + psum(pt_term, group))
