"""Incremental SfM (BASELINE config 2).

Port of :mod:`pysfm_tpu.pipeline.incremental`: two-view bootstrap, then
per batch of keyframes a RANSAC'd P3P resection, triangulation of the
newly visible tracks, and a windowed bundle adjustment through
:func:`~pysfm_tpu_torch.solver.solve`.  The per-keyframe orchestration
runs on the host (numpy bookkeeping, the same as the JAX package's), and
every inner solve is one batched computation on ``device``: all candidate
init pairs x hypotheses in one two-view RANSAC, a batch of frames x
hypotheses x 4 P3P candidates in one resection, masked multi-view DLT, the
LM solve, and the post-BA reprojection.

The shapes are the reference's: RANSAC inputs padded to ``_pad_count``
(pairs) and ``_pow2_bucket(n, 128)`` (resection) with zero-weight rows, a
resection batch always ``register_batch`` frames (pad rows duplicate the
first frame), and the BA problems at the reference's bucketed shapes.  The
padding defines the sample space of the draws, so it is part of the
result; the BA buckets only ever served XLA's compile cache.

Randomness: every RANSAC draw goes through ``sampler``, a callable
``(weights [B, N], n_hypotheses, k) -> idx [B, n_hypotheses, k]``, called
once per batched RANSAC in the order in which the JAX package splits its
key (the bootstrap, then each resection).  The default draws from a
``torch.Generator`` on ``device`` seeded with ``config.seed``.

An f32 track table builds f32 BA problems, which take the projection
kernel on the card (the JAX package's rule); the RANSAC and triangulation
stages run in f64 on host-sized arrays, as in the reference.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from pysfm_tpu_torch.frontend import epipolar, p3p, ransac, triangulate
from pysfm_tpu_torch.geometry import projection
from pysfm_tpu_torch.problem import BundleProblem, make_problem
from pysfm_tpu_torch.solver import solve
from pysfm_tpu_torch.utils import timing
from pysfm_tpu_torch.utils.config import LMConfig as _LMConfig


@dataclasses.dataclass(frozen=True)
class IncrementalConfig:
    window: int = 5                  # cameras optimized in windowed BA
    ransac_hypotheses: int = 256
    epipolar_threshold: float = 1e-6   # Sampson (normalized coords, squared)
    pnp_threshold: float = 1e-5        # squared normalized-coord residual
    min_track_views: int = 2
    min_pnp_points: int = 5
    ba_iters_window: int = 10
    ba_iters_final: int = 30
    # Post-BA hygiene: deactivate observations with reprojection error above
    # clip(4 * 1.4826 * MAD, min_reproj_px, max_reproj_px); points left with
    # < min_track_views views lose their 3-D status (and may be
    # re-triangulated later from clean views).
    max_reproj_px: float = 4.0
    min_reproj_px: float = 0.3
    # Minimum triangulation (parallax) angle, degrees, gated at point
    # creation and in hygiene: rays subtending less give ill-conditioned
    # depth that drifts toward infinity under BA.
    min_tri_angle_deg: float = 1.0
    # Init-pair selection: candidate pairs ranked by common-track count; the
    # chosen pair needs its RANSAC-inlier median parallax above
    # ``init_min_parallax_deg`` (a marginal-parallax pair admits the
    # rotation-only degenerate pose, which two-view BA then fits to noise).
    init_max_pairs: int = 20
    init_min_parallax_deg: float = 4.0
    # Robust kernel: the redescending Cauchy weight makes gross outliers
    # (mismatched tracks) inert, where Huber's linear tail lets them pull.
    robust: str = "cauchy"
    robust_scale: float = 0.5
    # Frames resected per batched PnP dispatch (all against the same map
    # state) before the next windowed BA; keep <= window so the window BA
    # covers every newly registered camera.
    register_batch: int = 4
    seed: int = 0


@dataclasses.dataclass
class Reconstruction:
    """Host-side result: the final (globally adjusted) problem + history.

    ``problem`` carries ALL frames/tracks at static shape; inactive
    observations have ``obs_w == 0`` and unregistered cameras are frozen at
    identity.  ``registered``/``has_point`` give the live subsets.
    """

    problem: BundleProblem
    registered: np.ndarray          # [F] bool
    has_point: np.ndarray           # [T] bool
    stats: dict


def _pad_count(n: int, mult: int = 32) -> int:
    """Shape bucket of the RANSAC inputs (a multiple of ``mult``)."""
    return max(mult, int(np.ceil(n / mult)) * mult)


def _pow2_bucket(n: int, floor: int = 512) -> int:
    """Next power-of-two bucket at or above ``floor``."""
    b = floor
    while b < n:
        b *= 2
    return b


def _max_tri_angle(X_pts, R, t, obs_mask):
    """Max pairwise parallax angle (rad) subtended at each point by its
    observing camera centers.  X_pts [P,3]; R [F,3,3]; t [F,3];
    obs_mask [F,P] bool.  Host-side bookkeeping, per point over its
    observing subset (a compressed [P, K] table, K = max views a point).
    """
    P = X_pts.shape[0]
    C = -np.einsum("fij,fi->fj", R, t)                     # [F, 3] centers
    p_idx, f_idx = np.nonzero(obs_mask.T)                  # sorted by point
    counts = np.bincount(p_idx, minlength=P)
    K = int(counts.max(initial=1))
    start = np.zeros(P + 1, dtype=np.int64)
    np.cumsum(counts, out=start[1:])
    pos = np.arange(len(p_idx)) - start[p_idx]
    cam_tab = np.zeros((P, K), dtype=np.int64)
    m = np.zeros((P, K), dtype=bool)
    cam_tab[p_idx, pos] = f_idx
    m[p_idx, pos] = True
    d = X_pts[:, None, :] - C[cam_tab]                     # [P, K, 3]
    d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    cosang = np.einsum("pkd,pld->pkl", d, d)               # [P, K, K]
    pair_ok = m[:, :, None] & m[:, None, :]
    cosang = np.where(pair_ok, cosang, 1.0)
    return np.arccos(np.clip(cosang.min(axis=(1, 2)), -1.0, 1.0))  # [P]


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x [B, N, c]`` at ``idx [B, H, k]`` -> ``[B, H, k, c]``."""
    return torch.take_along_dim(x[:, None], idx[..., None], dim=2)


def _two_view_batch(idx, pn1s, pn2s, ws, *, threshold):
    """All candidate init pairs in ONE batched computation: the two-view
    RANSAC (8-point E, Sampson score) of every pair x hypothesis, the pose
    selection, and each point's parallax angle.  ``idx [B, H, 8]`` are the
    minimal sets.  Returns ``(R2 [B,3,3], t2 [B,3], inliers [B,N],
    Xtri [B,N,3], ang [B,N])``, ``ang`` being the triangulation angle each
    point subtends at the two camera centers."""

    def fit(idx_h, w):
        if idx_h is None:   # the all-inlier refit, weighted
            return epipolar.eight_point(pn1s[:, None], pn2s[:, None], w=w, essential=True)
        # A minimal set gathered: the same null vector as the one-hot
        # weighted [N, 9] system, from a [9, 9] SVD.
        return epipolar.eight_point(_gather_rows(pn1s, idx_h), _gather_rows(pn2s, idx_h),
                                    essential=True)

    def score(E):
        return epipolar.sampson_distance(E, pn1s[:, None], pn2s[:, None])

    res = ransac.ransac(
        idx, pn1s.shape[1], fit, score, sample_size=8,
        n_hypotheses=idx.shape[1], threshold=threshold, data_weights=ws,
    )
    R2, t2, _, Xtri = epipolar.select_pose(
        res.model, pn1s, pn2s, w=res.inliers.to(pn1s.dtype))
    # Parallax per point: the angle between the rays from the two camera
    # centers C0 = 0 and C1 = -R2^T t2.
    C1 = -torch.sum(R2 * t2[..., :, None], dim=-2)
    d1 = Xtri
    d2 = Xtri - C1[:, None]
    n1 = torch.linalg.norm(d1, dim=-1)
    n2 = torch.linalg.norm(d2, dim=-1)
    cosang = torch.sum(d1 * d2, dim=-1) / torch.clamp(n1 * n2, min=1e-12)
    ang = torch.acos(torch.clamp(cosang, -1.0, 1.0))
    return R2, t2, res.inliers, Xtri, ang


def _pnp_batch(idx, Xps, pns, wps, *, threshold):
    """A batch of P3P-RANSAC resections in ONE batched computation (the
    frame axis leads).  Returns ``(R [B,3,3], t [B,3], inliers [B,N])``."""
    return p3p.p3p_ransac(idx, Xps, pns, n_hypotheses=idx.shape[1],
                          threshold=threshold, data_weights=wps)


def _hygiene_uvhat(camera_model, R, t, intr, X, ff_all, tt_all, device):
    """Reprojection of every (static) observation slot for post-BA
    filtering: one device computation per BA round."""
    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    return projection.project(
        camera_model, dev(R[ff_all]), dev(t[ff_all]), dev(intr[ff_all]), dev(X[tt_all])
    ).cpu().numpy()


def run_incremental(
    uv: np.ndarray,        # [F, T, 2] pixel measurement of track t in frame f
    vis: np.ndarray,       # [F, T] bool visibility
    intr: np.ndarray,      # [F, I] intrinsics per frame
    camera_model: str = "pose",
    config: IncrementalConfig = IncrementalConfig(),
    *,
    device="cuda",
    sampler: Optional[Callable] = None,
) -> Reconstruction:
    """Run the full incremental pipeline on a track table.

    Bootstraps from the best-conditioned frame pair (inliers x parallax),
    then registers the remaining frames next-best-view first.  Runs on
    ``device`` (the card unless the caller asks for the CPU; there is no
    fallback).  ``sampler`` draws the RANSAC minimal sets (module note).
    """
    F, T = vis.shape
    cfg = config
    if cfg.register_batch > cfg.window:
        # The windowed BA must cover every newly registered camera before it
        # becomes fixed context; silently degraded poses for the overflow
        # cameras are worse than a loud error.
        raise ValueError(
            f"register_batch ({cfg.register_batch}) must be <= window "
            f"({cfg.window}) so windowed BA optimizes every newly "
            "registered camera"
        )
    device = torch.device(device)
    if sampler is None:
        sampler = ransac.generator_sampler(cfg.seed, device)

    def dev(a):
        return torch.as_tensor(np.array(a), device=device)

    timings = {
        "pnp": 0.0, "triangulate": 0.0, "window_ba": 0.0,
        "hygiene": 0.0, "bootstrap": 0.0, "host_other": 0.0,
    }
    _t_run0 = time.perf_counter()

    class _T:
        """Accumulate the wall time of a stage into ``timings``, fenced by
        device synchronizes so queued work lands in its own stage."""

        def __init__(self, name):
            self.name = name

        def __enter__(self):
            timing.sync()
            self.t0 = time.perf_counter()

        def __exit__(self, *a):
            timing.sync()
            timings[self.name] += time.perf_counter() - self.t0

    # Normalized coordinates for every (frame, track), batched, once.
    pn_all = triangulate.pixel_to_normalized(
        camera_model, dev(intr)[:, None, :], dev(uv)).cpu().numpy()   # [F, T, 2]

    R = np.tile(np.eye(3), (F, 1, 1))
    t = np.zeros((F, 3))
    X = np.zeros((T, 3))
    X[:, 2] = 10.0  # safe depth for padding rows (keeps projection finite)
    registered = np.zeros(F, bool)
    has_pt = np.zeros(T, bool)
    # `active` masks observations considered live; post-BA filtering turns
    # off high-residual ones (they never return).
    active = vis.copy()
    stats = {"bootstrap_inliers": 0, "init_pair": None, "init_pairs_tried": [],
             "pnp_inliers": [], "ba_costs": [], "filtered_obs": 0,
             "pnp_candidates": []}

    # Static observation list for every BA problem in this run.
    ff_all, tt_all = np.nonzero(vis)

    min_angle = np.deg2rad(cfg.min_tri_angle_deg)

    # ---- init-pair selection + two-view bootstrap ----------------------
    counts = np.einsum("ft,gt->fg", vis.astype(np.int64), vis.astype(np.int64))
    iu = np.triu_indices(F, k=1)
    order = np.argsort(counts[iu])[::-1]
    cand_pairs = [
        (int(iu[0][k]), int(iu[1][k]))
        for k in order[: cfg.init_max_pairs]
        if counts[iu[0][k], iu[1][k]] >= 8
    ]
    if not cand_pairs:
        raise ValueError("no frame pair shares >= 8 tracks")

    idx_list = [np.flatnonzero(vis[i0] & vis[i1]) for i0, i1 in cand_pairs]
    npad = _pad_count(max(len(ix) for ix in idx_list))
    NP = len(cand_pairs)
    pn1s = np.zeros((NP, npad, 2))
    pn2s = np.zeros((NP, npad, 2))
    ws = np.zeros((NP, npad))
    for k, ((i0, i1), ix) in enumerate(zip(cand_pairs, idx_list)):
        n = len(ix)
        pn1s[k, :n] = pn_all[i0, ix]
        pn2s[k, :n] = pn_all[i1, ix]
        ws[k, :n] = 1.0
    with _T("bootstrap"):
        idx = sampler(dev(ws), cfg.ransac_hypotheses, 8)
        out = _two_view_batch(idx, dev(pn1s), dev(pn2s), dev(ws),
                              threshold=cfg.epipolar_threshold)
        R2b, t2b, inlb, Xtrib, angb = (o.cpu().numpy() for o in out)
    inlb = inlb & (ws > 0)

    best = None  # (score, n_inl, i0, i1, idx, inl, R2, t2, Xtri, ang)
    gate = np.deg2rad(cfg.init_min_parallax_deg)
    for k, ((i0, i1), idx) in enumerate(zip(cand_pairs, idx_list)):
        inl = inlb[k]
        n_inl = int(inl.sum())
        if n_inl < 8:
            continue
        med = float(np.median(angb[k][inl]))
        score = n_inl * (1.0 if med >= gate else 0.0)
        stats["init_pairs_tried"].append(
            (i0, i1, n_inl, round(np.rad2deg(med), 2))
        )
        entry = (
            score, n_inl, i0, i1, idx, inl, R2b[k], t2b[k], Xtrib[k],
            angb[k][inl],
        )
        if best is None or (score, n_inl) > (best[0], best[1]):
            best = entry
    if best is None:
        raise ValueError("two-view bootstrap failed on every candidate pair")
    _, n_inl, i0, i1, idx, inl, R2n, t2n, Xtri, ang = best
    stats["init_pair"] = (i0, i1)
    stats["bootstrap_inliers"] = n_inl

    scale = max(float(np.linalg.norm(t2n)), 1e-12)
    R[i1] = R2n
    t[i1] = t2n / scale              # unit-baseline scale gauge
    registered[i0] = registered[i1] = True
    # Assign triangulated, parallax-gated inliers (padded axis -> track ids;
    # `ang` was computed on the inlier subset, expand it back).
    keep = inl.copy()
    keep[inl] &= ang >= min_angle
    ok_rows = np.flatnonzero(keep[: len(idx)])
    X[idx[ok_rows]] = Xtri[ok_rows] / scale
    has_pt[idx[ok_rows]] = True

    def renormalize():
        """Scale-gauge renormalization: similarity-rescale about the anchor
        camera so the init-pair baseline keeps unit length."""
        C0 = -R[i0].T @ t[i0]
        C1 = -R[i1].T @ t[i1]
        base = np.linalg.norm(C1 - C0)
        if base < 1e-9:
            return
        s = 1.0 / base
        reg = np.flatnonzero(registered)
        C = -np.einsum("fij,fi->fj", R[reg], t[reg])
        C = C0 + s * (C - C0)
        t[reg] = -np.einsum("fij,fj->fi", R[reg], C)
        live = has_pt
        X[live] = C0 + s * (X[live] - C0)

    def _solve(prob, iters):
        with _T("window_ba"):
            solved, st = solve(prob, _LMConfig(max_iters=iters))
            stats["ba_costs"].append(float(st.costs[-1]))
        return (solved.R.cpu().numpy(), solved.t.cpu().numpy(),
                solved.X.cpu().numpy())

    def _full_ba(free_mask, iters):
        """BA over the full static-shape problem (bootstrap + final polish)."""
        obs_w = (
            active[ff_all, tt_all] & registered[ff_all] & has_pt[tt_all]
        ).astype(np.float64)
        X_dev = np.where(has_pt[:, None], X, np.array([0.0, 0.0, 10.0]))
        fixed = ~free_mask
        fixed[i0] = True  # gauge anchor (scale handled by renormalize())
        prob = make_problem(
            R, t, intr, X_dev, ff_all, tt_all, uv[ff_all, tt_all],
            camera_model=camera_model,
            robust=cfg.robust, robust_scale=cfg.robust_scale,
            cam_fixed=fixed | ~registered,
            obs_w=obs_w, device=device,
        )
        R[:], t[:], X[:] = _solve(prob, iters)

    def _window_ba_extracted():
        """Window BA on an EXTRACTED subproblem at bucketed shapes: the
        solve touches only the window cameras, the points they see, and
        the registered cameras anchoring those points (O(window) work per
        keyframe instead of O(F))."""
        reg_idx = np.flatnonzero(registered)
        win_mask = np.zeros(F, bool)
        win_mask[reg_idx[-cfg.window:]] = True
        sel_pt_mask = has_pt & active[win_mask].any(axis=0)
        sel_pts = np.flatnonzero(sel_pt_mask)
        cam_mask = registered & (
            win_mask | active[:, sel_pts].any(axis=1)
        )
        sel_cams = np.flatnonzero(cam_mask)
        nc, np_ = len(sel_cams), len(sel_pts)
        sub_vis = active[np.ix_(sel_cams, sel_pts)]
        fl, tl = np.nonzero(sub_vis)
        nm = len(fl)

        Cs = _pow2_bucket(nc, 8)
        Ps = _pow2_bucket(np_, 128)
        Ms = _pow2_bucket(nm, 512)
        # Table buckets (>= actual maxima; make_problem validates).
        k_pt = int(np.bincount(tl, minlength=1).max()) if nm else 1
        k_cam = int(np.bincount(fl, minlength=1).max()) if nm else 1
        Kb = _pad_count(k_pt, 4)
        Kcb = _pow2_bucket(k_cam, 64)

        R_s = np.tile(np.eye(3), (Cs, 1, 1))
        t_s = np.zeros((Cs, 3))
        intr_s = np.tile(intr[0], (Cs, 1))
        R_s[:nc] = R[sel_cams]
        t_s[:nc] = t[sel_cams]
        intr_s[:nc] = intr[sel_cams]
        X_s = np.tile(np.array([0.0, 0.0, 10.0]), (Ps, 1))
        X_s[:np_] = X[sel_pts]
        fixed_s = np.ones(Cs, bool)
        fixed_s[:nc] = ~win_mask[sel_cams]
        loc_i0 = np.searchsorted(sel_cams, i0)
        if loc_i0 < nc and sel_cams[loc_i0] == i0:
            fixed_s[loc_i0] = True  # gauge anchor stays frozen
        if fixed_s[:nc].all():
            return  # nothing free to optimize (degenerate window)

        oc_s = np.zeros(Ms, np.int64)
        op_s = np.zeros(Ms, np.int64)
        uv_s = np.zeros((Ms, 2), dtype=uv.dtype)
        w_s = np.zeros(Ms)
        oc_s[:nm] = fl
        op_s[:nm] = tl
        uv_s[:nm] = uv[sel_cams[fl], sel_pts[tl]]
        w_s[:nm] = 1.0

        prob = make_problem(
            R_s, t_s, intr_s, X_s, oc_s, op_s, uv_s,
            camera_model=camera_model,
            robust=cfg.robust, robust_scale=cfg.robust_scale,
            cam_fixed=fixed_s, obs_w=w_s,
            max_track=Kb, max_cam_obs=Kcb, device=device,
        )
        R_o, t_o, X_o = _solve(prob, cfg.ba_iters_window)
        free_rows = np.flatnonzero(~fixed_s[:nc])
        R[sel_cams[free_rows]] = R_o[free_rows]
        t[sel_cams[free_rows]] = t_o[free_rows]
        X[sel_pts] = X_o[:np_]

    def windowed_ba(final=False):
        reg_idx = np.flatnonzero(registered)
        if final or len(reg_idx) <= cfg.window + 1:
            free = np.zeros(F, bool)
            free[reg_idx if final else reg_idx[-cfg.window:]] = True
            _full_ba(free, cfg.ba_iters_final if final else cfg.ba_iters_window)
        else:
            _window_ba_extracted()
        renormalize()
        # Hygiene: deactivate observations whose reprojection error exceeds
        # the bound; demote points left under-observed.
        with _T("hygiene"):
            uv_hat = _hygiene_uvhat(
                camera_model, R, t, intr, X, ff_all, tt_all, device
            )
        err = np.linalg.norm(uv_hat - uv[ff_all, tt_all], axis=-1)
        live = active[ff_all, tt_all] & registered[ff_all] & has_pt[tt_all]
        sigma = 1.4826 * np.median(err[live]) if live.any() else 0.0
        thr = float(np.clip(4.0 * sigma, cfg.min_reproj_px, cfg.max_reproj_px))
        bad = (err > thr) & live
        if bad.any():
            active[ff_all[bad], tt_all[bad]] = False
            stats["filtered_obs"] += int(bad.sum())
            view_counts = (active & registered[:, None]).sum(axis=0)
            has_pt[view_counts < cfg.min_track_views] = False
        # Demote points whose post-BA parallax has degenerated (drifting
        # toward infinity); they may re-triangulate later from clean views.
        live = np.flatnonzero(has_pt)
        if len(live) > 0:
            reg_i = np.flatnonzero(registered)
            pang = _max_tri_angle(
                X[live], R[reg_i], t[reg_i], active[reg_i][:, live]
            )
            has_pt[live[pang < min_angle]] = False

    windowed_ba()

    # ---- incremental loop, next-best-view order --------------------------
    def resect_frames(frames):
        """Resect a BATCH of candidate frames in one batched P3P-RANSAC,
        all against the SAME map state (their poses do not depend on the
        order of acceptance); returns the accepted subset.  The batch axis
        is always ``register_batch`` and the point axis a power-of-two
        bucket, as in the reference."""
        B = max(1, cfg.register_batch)
        n_uses = [int((active[f] & has_pt).sum()) for f in frames]
        npad = _pow2_bucket(max(n_uses), 128)
        Xps = np.tile(np.array([0.0, 0.0, 10.0]), (B, npad, 1))
        pns = np.zeros((B, npad, 2))
        wps = np.zeros((B, npad))
        for k, f in enumerate(frames):
            uidx = np.flatnonzero(active[f] & has_pt)
            stats["pnp_candidates"].append(len(uidx))
            Xps[k, : len(uidx)] = X[uidx]
            pns[k, : len(uidx)] = pn_all[f, uidx]
            wps[k, : len(uidx)] = 1.0
        # Pad batch rows (short final batches) duplicate the first real
        # frame: an all-zero weight row has no sampling distribution.
        # Duplicate results are discarded.
        for k in range(len(frames), B):
            Xps[k] = Xps[0]
            pns[k] = pns[0]
            wps[k] = wps[0]
        with _T("pnp"):
            idx = sampler(dev(wps), cfg.ransac_hypotheses, 3)
            out = _pnp_batch(idx, dev(Xps), dev(pns), dev(wps),
                             threshold=cfg.pnp_threshold)
            Rb, tb, inlb = (o.cpu().numpy() for o in out)
            inlb = inlb & (wps > 0)
        newly = []
        for k, f in enumerate(frames[:B]):
            n_inl = int(inlb[k].sum())
            stats["pnp_inliers"].append(n_inl)
            if n_inl < cfg.min_pnp_points:
                # Resection unreliable: skip rather than poisoning the map
                # with a garbage pose; retried after the map grows.
                continue
            R[f] = Rb[k]
            t[f] = tb[k]
            registered[f] = True
            newly.append(f)
        return newly

    def triangulate_new(new_frames):
        """Triangulate tracks newly visible in >= min_track_views
        registered frames (masked multi-view DLT) in one batched
        computation for the whole batch of newly registered frames."""
        obs_reg = active & registered[:, None]              # [F, T]
        counts_t = obs_reg.sum(axis=0)
        new = (
            (~has_pt)
            & (counts_t >= cfg.min_track_views)
            & active[new_frames].any(axis=0)
        )
        nidx = np.flatnonzero(new)
        if len(nidx) == 0:
            return
        # View axis restricted to the registered frames, padded to a
        # bucket of 8, and the point axis to a bucket of 64.
        reg_i = np.flatnonzero(registered)
        Fr = _pow2_bucket(len(reg_i), 8)
        R_r = np.tile(np.eye(3), (Fr, 1, 1))
        t_r = np.zeros((Fr, 3))
        R_r[: len(reg_i)] = R[reg_i]
        t_r[: len(reg_i)] = t[reg_i]
        npadt = _pow2_bucket(len(nidx), 64)
        mask = np.zeros((npadt, Fr))
        pn_sel = np.zeros((npadt, Fr, 2))
        mask[: len(nidx), : len(reg_i)] = obs_reg[reg_i][:, nidx].T
        pn_sel[: len(nidx), : len(reg_i)] = (
            pn_all[reg_i][:, nidx].transpose(1, 0, 2)
        )
        with _T("triangulate"):
            Rj, tj, mj = dev(R_r), dev(t_r), dev(mask)
            Xn = triangulate.triangulate_linear(Rj, tj, dev(pn_sel), mj)  # [npadt, 3]
            # Cheirality screen: every observing view must see z > 0.
            z = triangulate.depths(Rj, tj, Xn[:, None, :])                # [npadt, Fr]
            good = (torch.sum((z > 0) * mj, dim=1) >= torch.sum(mj, dim=1)).cpu().numpy()
            Xn_np = Xn.cpu().numpy()
        good[: len(nidx)] &= mask[: len(nidx)].sum(axis=1) >= 2
        good[len(nidx):] = False
        # Parallax gate: reject depth-ill-conditioned triangulations.
        ang_n = _max_tri_angle(
            Xn_np, R[reg_i], t[reg_i], (mask[:, : len(reg_i)] > 0).T,
        )
        good &= ang_n >= min_angle
        sel_rows = np.flatnonzero(good[: len(nidx)])
        X[nidx[sel_rows]] = Xn_np[sel_rows]
        has_pt[nidx[sel_rows]] = True

    remaining = [f for f in range(F) if not registered[f]]
    failed: set = set()
    while True:
        # Next-best-view: most usable 2D-3D correspondences first; frames
        # that failed since the last map improvement wait for the next one.
        cand = [
            f for f in remaining
            if f not in failed
            and int((active[f] & has_pt).sum()) >= cfg.min_pnp_points
        ]
        if not cand:
            break
        cand.sort(key=lambda f: -(int((active[f] & has_pt).sum())))
        batch = cand[: max(1, cfg.register_batch)]
        newly = resect_frames(batch)
        if not newly:
            failed.update(batch)
            continue
        failed.clear()  # the map is about to improve: failures retry
        for f in newly:
            remaining.remove(f)
        triangulate_new(newly)
        windowed_ba()

    windowed_ba(final=True)
    obs_w = (
        active[ff_all, tt_all] & registered[ff_all] & has_pt[tt_all]
    ).astype(np.float64)
    X_dev = np.where(has_pt[:, None], X, np.array([0.0, 0.0, 10.0]))
    fixed = ~registered.copy()
    fixed[i0] = True
    prob = make_problem(
        R, t, intr, X_dev, ff_all, tt_all, uv[ff_all, tt_all],
        camera_model=camera_model,
        robust=cfg.robust, robust_scale=cfg.robust_scale,
        cam_fixed=fixed, obs_w=obs_w, device=device,
    )
    timings["host_other"] = (
        time.perf_counter() - _t_run0 - sum(timings.values())
    )
    stats["timings_s"] = {k: round(v, 3) for k, v in timings.items()}
    return Reconstruction(
        problem=prob, registered=registered, has_point=has_pt, stats=stats
    )
