"""Matrix-free Schur solve: preconditioned CG on the reduced camera system.

Port of :mod:`pysfm_tpu.solver.pcg`.  The reduced system ``S dc = rhs`` is
solved without forming S:

    S x = Hcc_aug x - Hcp (Hpp_aug^-1 (Hcp^T x))

Three operator routes, chosen by :func:`build_pcg_system` as in the JAX
module:

- **kernels** (``gops`` given, coupling rows only in ``gops.b_rows`` and
  ``gops.b_cam``): the reduced rhs, the block-Jacobi diagonal and every
  product with Hcp run through :mod:`~pysfm_tpu_torch.solver.kernels.spmv`
  (CUDA kernels on the card, their plain versions on the CPU);
- **tables**: ``B_cm`` gathered once per LM iteration into the padded
  point-major and camera-major visibility tables;
- **segment sums** over the observations (``index_add_``), the independent
  formulation the tests compare against.

Points blocks live in 6-component lower-triangular form ``[6, P]``; camera
vectors are component-major ``[CP, C]``.  The preconditioner is the exact
block-Jacobi diagonal of S, inverted by a batched Cholesky that falls back
to the damped ``Hcc`` block where a block is not positive definite.

Distributed (``group``, a :class:`~pysfm_tpu_torch.dist.mesh.Mesh`, where
the JAX functions take ``axis_name``): points, observations and the kernel
operands are this rank's shard, and ``eqs`` arrives with Hcc and g_c summed
(:func:`schur.sum_cameras`, once per linearization); every S-matvec sums
the camera-sized ``[CP, C]`` partial over the ranks (one collective per CG
iteration), the reduced rhs and the preconditioner's partial once per LM
iteration.  :class:`CamShard`
partitions the camera axis of the reduced solve as well.

The JAX package runs CG inside one ``lax.while_loop``.  Here it is a host
loop over device tensors; its only host read per iteration is the ``go``
flag (one bool), so one CG iteration costs one device-to-host sync.  Under
a group that flag comes from summed (hence equal) values only, so every
rank leaves the loop at the same iteration: a rank that decided from a
local value would leave the others waiting in a collective.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from pysfm_tpu_torch.solver import scale as scale_mod
from pysfm_tpu_torch.solver import schur
from pysfm_tpu_torch.solver.kernels import spmv
from pysfm_tpu_torch.utils import precision as xp
from pysfm_tpu_torch.utils.collectives import all_gather, psum, psum_many, psum_scatter


class PCGSystem(NamedTuple):
    """Component-major (table), segment-sum or kernel PCG operator."""

    Hcc_aug: torch.Tensor    # [C, CP, CP] damped camera blocks
    hinv6: torch.Tensor      # [6, P] damped point-block inverses
    rhs: torch.Tensor        # [CP, C] reduced rhs, component-major
    g_p: torch.Tensor        # [3, P] point gradient
    M_inv: torch.Tensor      # [C, CP, CP] block-Jacobi preconditioner inverse
    # Gathered-domain operands (None off the table route).
    Bp: Optional[torch.Tensor]    # [3*CP, K, P] masked point-major rows
    camg: Optional[torch.Tensor]  # [K, P] camera id per slot
    Bg: Optional[torch.Tensor]    # [3*CP, C, Kc] masked camera-major rows
    ptg: Optional[torch.Tensor]   # [C, Kc] point id per slot
    # Per-observation operands of the segment-sum route.
    B_cm: Optional[torch.Tensor]    # [3*CP, M]
    obs_cam: Optional[torch.Tensor]
    obs_pt: Optional[torch.Tensor]
    # Kernel operands (spmv.GroupedOps with b_rows, b_cam set) on the kernel
    # route: every product with Hcp runs through the spmv kernels.
    gops: Optional[object] = None
    # The damped block diagonal of S, kept only for the power-series
    # preconditioner (precond_terms > 1).
    D_blk: Optional[torch.Tensor] = None  # [C, CP, CP]


class CamShard(NamedTuple):
    """The camera-axis partition of the reduced solve.

    On a mesh of ``n_shards`` ranks, rank ``k`` owns camera rows
    ``[k*n_local, (k+1)*n_local)`` of the padded range ``n_shards * n_local
    >= n_cams``.  The damped camera blocks, the reduced rhs, the
    block-Jacobi inverse and the CG vectors live only on their owner rank;
    each rank's per-camera partials reach the owners through one
    reduce-scatter (the point-parallel sum and the routing in one
    collective), and the matvec all-gathers the ``[CP, C]`` iterate.  The
    pad rows beyond ``n_cams`` are zero: their blocks become the identity
    (``augment_block_diag``'s unit fill) and their rhs is zero, so CG keeps
    them zero."""

    group: object   # dist.mesh.Mesh
    n_cams: int     # global C (unpadded)
    n_local: int    # padded camera rows a rank (ceil(C / n_shards))
    n_shards: int

    @property
    def n_pad(self) -> int:
        return self.n_local * self.n_shards


def make_cam_shard(group, n_cams: int, n_shards: int) -> CamShard:
    return CamShard(group=group, n_cams=n_cams, n_local=-(-n_cams // n_shards),
                    n_shards=n_shards)


def _scatter_cols(x: torch.Tensor, cam: CamShard) -> torch.Tensor:
    """[cp, C] rank partial -> [cp, n_local] owner columns (summed)."""
    pad = cam.n_pad - x.shape[1]
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return psum_scatter(x, cam.group, dim=1)


def _scatter_rows(x: torch.Tensor, cam: CamShard) -> torch.Tensor:
    """[C, ...] rank partial -> [n_local, ...] owner rows (summed)."""
    pad = cam.n_pad - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return psum_scatter(x, cam.group, dim=0)


def _own_rows(x: torch.Tensor, cam: CamShard) -> torch.Tensor:
    """[C, ...] (the same on every rank) -> this rank's [n_local, ...]
    rows, the pad rows zero."""
    pad = cam.n_pad - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    k = cam.group.rank * cam.n_local
    return x[k:k + cam.n_local].contiguous()


def _gather_x(x_local: torch.Tensor, cam: CamShard) -> torch.Tensor:
    """[cp, n_local] shard -> the full [cp, C] (unpadded) on every rank."""
    return all_gather(x_local, cam.group, dim=1)[:, :cam.n_cams].contiguous()


def _eqs_to_cm(eqs: schur.NormalEqs) -> scale_mod.ScaleEqs:
    """View a standard-layout NormalEqs as component-major (the
    segment-sum route's input for small problems and tests)."""
    cp = eqs.Hcc.shape[-1]
    hpp6 = torch.stack([eqs.Hpp[:, d, e] for d, e in scale_mod.TRI3])
    B_cm = eqs.B.permute(2, 1, 0).reshape(3 * cp, -1)
    return scale_mod.ScaleEqs(
        Hcc=eqs.Hcc, g_c=eqs.g_c, hpp6=hpp6, g_p=eqs.g_p.T, B_cm=B_cm
    )


def build_pcg_system(
    eqs,
    lam,
    obs_cam: torch.Tensor,
    obs_pt: torch.Tensor,
    pt_obsT: Optional[torch.Tensor] = None,
    pt_obs_maskT: Optional[torch.Tensor] = None,
    cam_obs: Optional[torch.Tensor] = None,
    cam_obs_mask: Optional[torch.Tensor] = None,
    gops=None,
    keep_D: bool = False,
    group=None,
    cam: Optional[CamShard] = None,
) -> PCGSystem:
    """Damp, invert point blocks, build the reduced rhs and the block-Jacobi
    preconditioner: everything except S itself.

    ``eqs`` is a :class:`scale.ScaleEqs` (the native layout) or a
    :class:`schur.NormalEqs` (converted).  The route: the kernels when
    ``gops`` is given and the coupling rows live only in ``gops.b_rows`` /
    ``gops.b_cam`` (``eqs.B_cm is None``, as the K_E build returns them),
    else the visibility tables when given, else segment sums.

    Under ``group`` ``eqs`` holds the summed Hcc and g_c
    (:func:`schur.sum_cameras`, once per linearization) and this rank's
    points; the reduced rhs and the preconditioner's diagonal, which come
    from the points, are summed over the ranks here.  With ``cam`` the
    system holds only this rank's ``cam.n_local`` camera rows: it takes its
    rows of Hcc and g_c, and a reduce-scatter sums the point-derived
    partials and routes them to their owners."""
    if isinstance(eqs, schur.NormalEqs):
        eqs = _eqs_to_cm(eqs)
    C, cp, _ = eqs.Hcc.shape
    Hcc, g_c = eqs.Hcc, eqs.g_c
    if cam is not None:
        Hcc, g_c = _own_rows(Hcc, cam), _own_rows(g_c, cam)
    Hcc_aug = schur.augment_block_diag(Hcc, lam)
    hinv6 = scale_mod.sym6_inv(scale_mod.augment6(eqs.hpp6, lam))

    use_grouped = gops is not None and eqs.B_cm is None
    use_tables = pt_obsT is not None and cam_obs is not None
    u0 = scale_mod.sym6_mv(hinv6, eqs.g_p)                     # [3, P]
    Bp = camg = Bg = ptg = None
    B_keep = oc_keep = op_keep = None
    if use_grouped:
        # Kernel route: the coupling rows live only in gops, so the
        # rhs and the exact block-Jacobi diagonal come from the kernels.
        rhs_red = spmv.hcp_w(gops, u0, C, cp=cp).to(g_c.dtype)
        D = spmv.precond_diag(gops, hinv6, C, cp=cp).to(Hcc_aug.dtype)
    elif use_tables:
        pmask_t = pt_obs_maskT.to(eqs.B_cm.dtype)               # [K, P]
        cmask = cam_obs_mask.to(eqs.B_cm.dtype)                 # [C, Kc]
        Bp = eqs.B_cm[:, pt_obsT] * pmask_t                     # [3CP, K, P]
        camg = obs_cam[pt_obsT]                                 # [K, P]
        Bg = eqs.B_cm[:, cam_obs] * cmask                       # [3CP, C, Kc]
        ptg = obs_pt[cam_obs]                                   # [C, Kc]
        Bg4 = Bg.reshape(3, cp, C, -1)
        # rhs_red[d,c] = sum_{s,k} Bg(d,s)[c,k] * u0[s, ptg[c,k]].
        rhs_red = torch.sum(Bg4 * u0[:, ptg][:, None], dim=(0, 3))  # [cp, C]
        # Exact block-Jacobi diag: D_c = Hcc_aug[c] - sum_k Bg Hinv Bg^T.
        a, b, c_, d_, e, f = hinv6[:, ptg]                      # each [C, Kc]
        B0, B1, B2 = Bg4[0], Bg4[1], Bg4[2]                     # [cp, C, Kc]
        BH0 = a * B0 + b * B1 + d_ * B2
        BH1 = b * B0 + c_ * B1 + e * B2
        BH2 = d_ * B0 + e * B1 + f * B2
        D = (
            xp.einsum("dck,eck->cde", BH0, B0)
            + xp.einsum("dck,eck->cde", BH1, B1)
            + xp.einsum("dck,eck->cde", BH2, B2)
        )
    else:
        B4 = eqs.B_cm.reshape(3, cp, -1)                        # [3, cp, M]
        z = xp.einsum("scm,sm->cm", B4, u0[:, obs_pt])          # [cp, M]
        rhs_red = torch.zeros((cp, C), dtype=z.dtype, device=z.device)
        rhs_red.index_add_(1, obs_cam, z)
        a, b, c_, d_, e, f = hinv6[:, obs_pt]                   # each [M]
        B0, B1, B2 = B4[0], B4[1], B4[2]                        # [cp, M]
        BH0 = a * B0 + b * B1 + d_ * B2
        BH1 = b * B0 + c_ * B1 + e * B2
        BH2 = d_ * B0 + e * B1 + f * B2
        D_m = (
            xp.einsum("dm,em->mde", BH0, B0)
            + xp.einsum("dm,em->mde", BH1, B1)
            + xp.einsum("dm,em->mde", BH2, B2)
        )
        D = torch.zeros((C, cp, cp), dtype=D_m.dtype, device=D_m.device)
        D.index_add_(0, obs_cam, D_m)
        B_keep, oc_keep, op_keep = eqs.B_cm, obs_cam, obs_pt
    if cam is not None:
        rhs_red, D = _scatter_cols(rhs_red, cam), _scatter_rows(D, cam)
    else:
        rhs_red, D = psum_many((rhs_red, D), group)
    rhs = (-g_c.T + rhs_red).contiguous()            # [cp, C] (or [cp, n_local])
    D = Hcc_aug - D
    # Batched Cholesky inverse of the [CP, CP] diagonal blocks; symmetrize
    # first (summation order) and fall back to the damped Hcc block where a
    # block is not SPD (transiently, at huge lam).  A failed factor is NaN,
    # never a partial one (schur._cholesky_nan).
    D = 0.5 * (D + D.transpose(-1, -2))
    L = schur._cholesky_nan(D)
    ok = torch.isfinite(L).all(dim=-1, keepdim=True).all(dim=-2, keepdim=True)
    L_safe = torch.where(ok, L, schur._cholesky_nan(Hcc_aug))
    eye = torch.eye(cp, dtype=D.dtype, device=D.device).expand(D.shape)
    M_inv = torch.cholesky_solve(eye, L_safe)
    return PCGSystem(
        Hcc_aug=Hcc_aug, hinv6=hinv6, rhs=rhs, g_p=eqs.g_p, M_inv=M_inv,
        Bp=Bp, camg=camg, Bg=Bg, ptg=ptg,
        B_cm=B_keep, obs_cam=oc_keep, obs_pt=op_keep,
        gops=gops if use_grouped else None, D_blk=D if keep_D else None,
    )


def _hcpT_x(sys: PCGSystem, x: torch.Tensor) -> torch.Tensor:
    """u = Hcp^T x with x [CP, C] component-major; returns [3, P]."""
    cp = x.shape[0]
    if sys.gops is not None:
        return spmv.hcpT_x(sys.gops, x.contiguous(), cp=cp)
    if sys.Bp is not None:
        Bp4 = sys.Bp.reshape(3, cp, *sys.Bp.shape[1:])          # [3,cp,K,P]
        return torch.sum(Bp4 * x[:, sys.camg][None], dim=(1, 2))
    B4 = sys.B_cm.reshape(3, cp, -1)
    u_m = xp.einsum("sdm,dm->sm", B4, x[:, sys.obs_cam])        # [3, M]
    u = torch.zeros((3, sys.hinv6.shape[1]), dtype=u_m.dtype, device=u_m.device)
    return u.index_add_(1, sys.obs_pt, u_m)


def _hcp_w(sys: PCGSystem, w: torch.Tensor, C: int) -> torch.Tensor:
    """z = Hcp w with w [3, P]; returns [CP, C]."""
    cp = sys.Hcc_aug.shape[-1]
    if sys.gops is not None:
        return spmv.hcp_w(sys.gops, w.contiguous(), C, cp=cp)
    if sys.Bg is not None:
        Bg4 = sys.Bg.reshape(3, cp, *sys.Bg.shape[1:])          # [3,cp,C,Kc]
        return torch.sum(Bg4 * w[:, sys.ptg][:, None], dim=(0, 3))
    B4 = sys.B_cm.reshape(3, cp, -1)
    z_m = xp.einsum("sdm,sm->dm", B4, w[:, sys.obs_pt])         # [cp, M]
    z = torch.zeros((cp, C), dtype=z_m.dtype, device=z_m.device)
    return z.index_add_(1, sys.obs_cam, z_m)


def _blockmv(H: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y[d, c] = sum_e H[c, d, e] x[e, c]``: [C, CP, CP] blocks times a
    component-major [CP, C] vector."""
    return xp.matvec(H, x.T).T


def schur_matvec(sys: PCGSystem, x: torch.Tensor, group=None,
                 cam: Optional[CamShard] = None) -> torch.Tensor:
    """y = S x with x, y [CP, C] component-major; S never formed.

    Under ``group`` the coupling term is summed over the ranks.  With
    ``cam`` x and y are this rank's [CP, n_local] camera shard: the iterate
    is all-gathered for the coupling term, and one reduce-scatter sums the
    ranks' partials and routes camera rows to their owners."""
    if cam is not None:
        x_full = _gather_x(x, cam)
        w = scale_mod.sym6_mv(sys.hinv6, _hcpT_x(sys, x_full))  # [3, P]
        z = _scatter_cols(_hcp_w(sys, w, cam.n_cams), cam)
        return _blockmv(sys.Hcc_aug, x) - z
    C = sys.Hcc_aug.shape[0]
    u = _hcpT_x(sys, x)
    w = scale_mod.sym6_mv(sys.hinv6, u)                         # [3, P]
    z = psum(_hcp_w(sys, w, C), group)
    return _blockmv(sys.Hcc_aug, x) - z


def _precond(sys: PCGSystem, r: torch.Tensor) -> torch.Tensor:
    return _blockmv(sys.M_inv, r)


def _precond_power(sys: PCGSystem, r: torch.Tensor, terms: int, group=None,
                   cam: Optional[CamShard] = None) -> torch.Tensor:
    """Truncated power-series preconditioner: with S = D - O and D the exact
    block-Jacobi diagonal, ``z_m = D^-1 (r + O z_{m-1})`` where
    ``O z = D z - S z`` costs one S-matvec per extra term.  ``terms=1`` is
    block-Jacobi.  Needs ``sys.D_blk``."""
    z = _precond(sys, r)
    for _ in range(terms - 1):
        Sz = schur_matvec(sys, z, group, cam)
        Dz = _blockmv(sys.D_blk, z)
        z = _precond(sys, r + Dz - Sz)
    return z


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


def pcg_solve(
    sys: PCGSystem,
    *,
    tol=1e-6,
    max_iters: int = 100,
    x0: Optional[torch.Tensor] = None,
    q_tol: float = 0.0,
    precond_terms: int = 1,
    return_iters: bool = False,
    group=None,
    cam: Optional[CamShard] = None,
):
    """Preconditioned CG for S dc = rhs; returns dc [CP, C] (or
    ``(dc, n_iters)`` with ``return_iters=True``, ``n_iters`` an int).

    ``x0`` warm-starts the iteration.  ``tol`` may be a tensor (the
    Eisenstat-Walker forcing sequence).  ``q_tol`` > 0 adds quadratic-model
    stagnation termination: stop at iteration i when
    ``i * (Q_{i-1} - Q_i) <= q_tol |Q_i|`` with Q(x) = 0.5 x'Sx - b'x.
    ``precond_terms`` > 1 applies the power-series preconditioner.  A
    direction with ``p'Sp <= 0`` (f32 rounding near convergence) stops the
    loop and keeps the current iterate.

    Under ``group`` (and ``cam``) every quantity that enters the CG scalars
    and the ``go`` flag is summed over the ranks, so all ranks take the
    same iterations.  With ``cam`` the vectors are this rank's camera shard
    and the returned dc is all-gathered to the full [CP, C].
    """
    b = sys.rhs
    tiny = torch.finfo(b.dtype).tiny

    def gdot(a, bb):
        # Camera-sharded vectors are disjoint shards: the global dot is
        # the sum of the local ones.
        d = _dot(a, bb)
        return d if cam is None else psum(d, cam.group)

    def precond(r):
        if precond_terms > 1:
            return _precond_power(sys, r, precond_terms, group, cam)
        return _precond(sys, r)

    if x0 is None:
        x = torch.zeros_like(b)
        r = b                                  # x0 = 0 => r = b - S x0 = b
        Q = torch.zeros((), dtype=b.dtype, device=b.device)
    else:
        if cam is not None:
            # The warm start arrives full [CP, C]; take this rank's columns.
            x0 = _own_rows(x0.T, cam).T.contiguous()
        x = x0
        r = b - schur_matvec(sys, x, group, cam)
        Q = -0.5 * (gdot(x, b) + gdot(x, r))   # Q(x0), with S x0 = b - r
    z = precond(r)
    p = z
    rz = gdot(r, z)
    thresh = tol * torch.clamp(torch.sqrt(gdot(b, b)), min=1e-30)
    done = torch.zeros((), dtype=torch.bool, device=b.device)
    dQ = torch.full((), torch.finfo(b.dtype).max, dtype=b.dtype, device=b.device)
    it = 0
    while it < max_iters:
        go = ~done & (torch.sqrt(gdot(r, r)) > thresh)
        if q_tol > 0.0 and it > 0:
            go = go & ~(it * dQ <= q_tol * torch.abs(Q))
        # The one host read of the CG iteration.
        if not bool(go):
            break
        Sp = schur_matvec(sys, p, group, cam)
        pSp = gdot(p, Sp)
        bad = ~(torch.isfinite(pSp) & (pSp > 0))
        alpha = torch.where(bad, torch.zeros_like(rz), rz / torch.clamp(pSp, min=tiny))
        x = x + alpha * p
        r = r - alpha * Sp
        z = precond(r)
        rz_new = gdot(r, z)
        beta = rz_new / torch.clamp(rz, min=tiny)
        p = z + beta * p
        dQ = 0.5 * alpha * rz                  # Q_{i-1} - Q_i (exact)
        Q = Q - dQ
        rz = rz_new
        done = bad
        it += 1
    if cam is not None:
        x = _gather_x(x, cam)
    if return_iters:
        return x, it
    return x


def back_substitute(sys: PCGSystem, dc: torch.Tensor) -> torch.Tensor:
    """dp = -Hpp_inv (g_p + Hcp^T dc), component-major [3, P]; ``dc``
    [CP, C]."""
    u = _hcpT_x(sys, dc)
    return -scale_mod.sym6_mv(sys.hinv6, sys.g_p + u)


def solve_step_pcg_cm3(
    eqs,
    lam,
    obs_cam: torch.Tensor,
    obs_pt: torch.Tensor,
    *,
    tol=1e-6,
    max_iters: int = 100,
    pt_obsT: Optional[torch.Tensor] = None,
    pt_obs_maskT: Optional[torch.Tensor] = None,
    cam_obs: Optional[torch.Tensor] = None,
    cam_obs_mask: Optional[torch.Tensor] = None,
    dc_warm: Optional[torch.Tensor] = None,
    gops=None,
    q_tol: float = 0.0,
    precond_terms: int = 1,
    group=None,
    cam_shards: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """One damped step with the point step kept component-major: returns
    ``(dc [C, CP], dp3 [3, P], n_cg)``.  ``eqs`` is a ScaleEqs or a
    standard-layout NormalEqs.

    ``dc_warm`` ([C, CP]) warm-starts CG with the previous LM iteration's
    camera step; ``gops`` (a :class:`spmv.GroupedOps` with the rows set)
    routes the products with Hcp through the kernels.  Under ``group``
    ``eqs`` holds the summed Hcc / g_c (:func:`schur.sum_cameras`) and the
    rank's points; ``cam_shards`` > 0 (with ``group``)
    partitions the camera axis of the reduced solve (:class:`CamShard`),
    and the returned dc is still the full [C, CP] step."""
    cam = None
    if cam_shards > 0:
        if group is None:
            raise ValueError("cam_shards requires group")
        cam = make_cam_shard(group, eqs.Hcc.shape[0], cam_shards)
    sys = build_pcg_system(
        eqs, lam, obs_cam, obs_pt,
        pt_obsT=pt_obsT, pt_obs_maskT=pt_obs_maskT,
        cam_obs=cam_obs, cam_obs_mask=cam_obs_mask,
        gops=gops, keep_D=precond_terms > 1, group=group, cam=cam,
    )
    x0 = None if dc_warm is None else dc_warm.T.contiguous()
    dc, n_cg = pcg_solve(
        sys, tol=tol, max_iters=max_iters, x0=x0, q_tol=q_tol,
        precond_terms=precond_terms, return_iters=True, group=group, cam=cam,
    )
    dp3 = back_substitute(sys, dc)
    return dc.T.contiguous(), dp3, n_cg


def solve_step_pcg(
    eqs,
    lam,
    obs_cam: torch.Tensor,
    obs_pt: torch.Tensor,
    *,
    tol=1e-6,
    max_iters: int = 100,
    pt_obsT: Optional[torch.Tensor] = None,
    pt_obs_maskT: Optional[torch.Tensor] = None,
    cam_obs: Optional[torch.Tensor] = None,
    cam_obs_mask: Optional[torch.Tensor] = None,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One damped step in the standard layout: ``(dc [C, CP], dp [P, 3])``;
    ``group`` as in :func:`solve_step_pcg_cm3`."""
    dc, dp3, _ = solve_step_pcg_cm3(
        eqs, lam, obs_cam, obs_pt, tol=tol, max_iters=max_iters,
        pt_obsT=pt_obsT, pt_obs_maskT=pt_obs_maskT,
        cam_obs=cam_obs, cam_obs_mask=cam_obs_mask, group=group,
    )
    return dc, dp3.T
