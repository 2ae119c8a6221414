"""P3P: minimal 3-point absolute pose (Grunert's formulation).

Port of :mod:`pysfm_tpu.frontend.p3p`.  The Grunert system is reduced to
one quartic whose coefficients come from exact polynomial arithmetic, and
the quartic is solved in closed form (Ferrari) in REAL arithmetic: both
branches of the resolvent cubic are evaluated and selected elementwise,
then three safeguarded Newton steps polish the roots.  A complex-root path
(or the eigenvalues of a companion matrix) gives wrong double roots, so
none is used.  Each sample yields up to 4 candidate poses; invalid
candidates come back as NaN and scoring discards them.  Every function
broadcasts over leading batch dimensions (hypotheses, frames).
"""

from __future__ import annotations

from typing import Tuple

import torch

from pysfm_tpu_torch.frontend.pnp import proper_rotation, refine_pose
from pysfm_tpu_torch.frontend.ransac import sample_indices
from pysfm_tpu_torch.utils import precision as xp


def solve_quartic(coeffs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form (Ferrari) REAL roots of c4 x^4 + ... + c1 x + c0.

    ``coeffs [..., 5] = [c4, c3, c2, c1, c0]``; returns ``(roots [..., 4],
    valid [..., 4])`` where invalid slots mark complex-conjugate pairs
    (their values are meaningless).  The resolvent cubic is split into the
    real-Cardano (disc >= 0) and trigonometric (disc < 0, three real roots)
    branches, both evaluated and selected elementwise.
    """
    c4, c3, c2, c1, c0 = coeffs.unbind(-1)
    f64 = coeffs.dtype == torch.float64
    tiny = 1e-30 if f64 else 1e-18
    a = c3 / c4
    b = c2 / c4
    c = c1 / c4
    d = c0 / c4

    # Depressed quartic y^4 + p y^2 + q y + r with x = y - a/4.
    p = b - 3.0 * a * a / 8.0
    q = c - a * b / 2.0 + a * a * a / 8.0
    r = d - a * c / 4.0 + a * a * b / 16.0 - 3.0 * a ** 4 / 256.0

    # Resolvent cubic z^3 - p z^2 - 4 r z + (4 p r - q^2) = 0; any real root
    # works (one always exists).  Depress: t^3 + P t + Q with z = t - A/3.
    A = -p
    P = -4.0 * r - A * A / 3.0
    Q = (4.0 * p * r - q * q) - A * (-4.0 * r) / 3.0 + 2.0 * A ** 3 / 27.0
    disc = (Q / 2.0) ** 2 + (P / 3.0) ** 3

    def _cbrt(w):
        return torch.sign(w) * torch.abs(w) ** (1.0 / 3.0)

    # disc >= 0: one real root via real Cardano.
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_card = _cbrt(-Q / 2.0 + sq) + _cbrt(-Q / 2.0 - sq)
    # disc < 0 (requires P < 0): three real roots; take the largest, which
    # maximizes m^2 = z - p below and keeps the quadratic split stable.
    Pn = torch.clamp(P, max=-tiny)
    sP = torch.sqrt(-Pn / 3.0)
    cosarg = torch.clamp(3.0 * Q / (2.0 * Pn) * torch.sqrt(-3.0 / Pn), -1.0, 1.0)
    t_trig = 2.0 * sP * torch.cos(torch.acos(cosarg) / 3.0)
    t1 = torch.where(disc >= 0, t_card, t_trig)
    z = t1 - A / 3.0

    # Factor into two quadratics: y^2 -+ m y + (z/2 -+ q/(2m)).
    m2 = z - p
    biquad = m2 < tiny
    m = torch.sqrt(torch.clamp(m2, min=0.0))
    m_safe = torch.where(biquad, torch.ones_like(m), m)
    alpha = z / 2.0 - q / (2.0 * m_safe)
    beta = z / 2.0 + q / (2.0 * m_safe)
    d1s = m * m - 4.0 * alpha
    d2s = m * m - 4.0 * beta
    d1 = torch.sqrt(torch.clamp(d1s, min=0.0))
    d2 = torch.sqrt(torch.clamp(d2s, min=0.0))
    roots_gen = torch.stack(
        [(-m + d1) / 2.0, (-m - d1) / 2.0, (m + d2) / 2.0, (m - d2) / 2.0], dim=-1)
    # Permissive validity: a repeated real root's discriminant can round
    # slightly negative; admitting a borderline complex pair is harmless
    # (callers score candidates), dropping a real double root is not.
    eps = 1e-9 if f64 else 1e-4
    ok1 = d1s >= -eps * (m * m + 4.0 * torch.abs(alpha) + 1.0)
    ok2 = d2s >= -eps * (m * m + 4.0 * torch.abs(beta) + 1.0)
    valid_gen = torch.stack([ok1, ok1, ok2, ok2], dim=-1)

    # If m ~ 0 the quartic is biquadratic: y^2 = (-p +- sqrt(p^2 - 4 r))/2.
    s_bi2 = p * p - 4.0 * r
    s_bi = torch.sqrt(torch.clamp(s_bi2, min=0.0))
    alpha_bi = (-p + s_bi) / 2.0
    beta_bi = (-p - s_bi) / 2.0
    rt_a = torch.sqrt(torch.clamp(alpha_bi, min=0.0))
    rt_b = torch.sqrt(torch.clamp(beta_bi, min=0.0))
    roots_bi = torch.stack([rt_a, -rt_a, rt_b, -rt_b], dim=-1)
    ok_a = (s_bi2 >= 0) & (alpha_bi >= 0)
    ok_b = (s_bi2 >= 0) & (beta_bi >= 0)
    valid_bi = torch.stack([ok_a, ok_a, ok_b, ok_b], dim=-1)
    y = torch.where(biquad[..., None], roots_bi, roots_gen)
    valid = torch.where(biquad[..., None], valid_bi, valid_gen)
    x = y - (a / 4.0)[..., None]

    # Safeguarded Newton polish on the undepressed quartic: near a double
    # root f and f' are both noise-dominated and the raw step f/f' can jump
    # away from an already-correct root, so a step is accepted only if it
    # reduces |f|.
    c4, c3, c2, c1, c0 = (v[..., None] for v in (c4, c3, c2, c1, c0))

    def _poly(u):
        return (((c4 * u + c3) * u + c2) * u + c1) * u + c0

    f = _poly(x)
    for _ in range(3):
        fp = ((4.0 * c4 * x + 3.0 * c3) * x + 2.0 * c2) * x + c1
        fp = torch.where(torch.abs(fp) < tiny, torch.full_like(fp, tiny), fp)
        x_new = x - f / fp
        f_new = _poly(x_new)
        better = torch.abs(f_new) < torch.abs(f)
        x = torch.where(better, x_new, x)
        f = torch.where(better, f_new, f)
    return x, valid


def _poly_mul(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Product of polynomials given as low-to-high coefficients on the last
    dim (``jnp.convolve``'s full mode), batched."""
    n1, n2 = p1.shape[-1], p2.shape[-1]
    out = [0.0] * (n1 + n2 - 1)
    for i in range(n1):
        for j in range(n2):
            out[i + j] = out[i + j] + p1[..., i] * p2[..., j]
    return torch.stack(out, dim=-1)


def p3p(
    X: torch.Tensor,    # [..., 3, 3] world points
    pn: torch.Tensor,   # [..., 3, 2] normalized image coords (pinhole)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grunert P3P: up to 4 poses.  Returns (R [..., 4, 3, 3], t [..., 4,
    3]); invalid slots are NaN.

    With unit bearings f_i and side lengths a=|P2P3|, b=|P1P3|, c=|P1P2|,
    the depth ratios u=s2/s1, v=s3/s1 satisfy two quadrics; eliminating u
    yields a quartic in v built with exact polynomial arithmetic.
    """
    f = torch.cat([pn, torch.ones_like(pn[..., :1])], dim=-1)
    f = f / torch.linalg.norm(f, dim=-1, keepdim=True)        # [..., 3, 3] bearings

    a2 = torch.sum((X[..., 1, :] - X[..., 2, :]) ** 2, dim=-1)
    b2 = torch.sum((X[..., 0, :] - X[..., 2, :]) ** 2, dim=-1)
    c2 = torch.sum((X[..., 0, :] - X[..., 1, :]) ** 2, dim=-1)
    ca = torch.sum(f[..., 1, :] * f[..., 2, :], dim=-1)   # cos(alpha), opposite side a
    cb = torch.sum(f[..., 0, :] * f[..., 2, :], dim=-1)
    cg = torch.sum(f[..., 0, :] * f[..., 1, :], dim=-1)

    A = a2 / b2
    Bc = c2 / b2
    # S(v) = 1 - 2 cb v + v^2 ; N(v) = (1 + (A - Bc)) + (-(A - Bc) 2 cb) v
    # + ((A - Bc) - 1) v^2 ; D(v) = 2 cg - 2 ca v ; substituting u = N/D
    # into 1 + u^2 - 2 u cg = Bc S gives the quartic
    # N^2 - 2 cg N D + D^2 - Bc S D^2 = 0.
    one = torch.ones_like(cb)
    S = torch.stack([one, -2.0 * cb, one], dim=-1)
    AB = A - Bc
    N = torch.stack([1.0 + AB, -2.0 * cb * AB, AB - 1.0], dim=-1)
    D = torch.stack([2.0 * cg, -2.0 * ca], dim=-1)
    NN = _poly_mul(N, N)                       # degree 4 (5 coeffs)
    ND = _poly_mul(N, D)                       # degree 3
    DD = _poly_mul(D, D)                       # degree 2
    SDD = _poly_mul(S, DD)                     # degree 4
    quartic = NN - Bc[..., None] * SDD
    quartic = quartic + torch.nn.functional.pad(-2.0 * cg[..., None] * ND, (0, 1))
    quartic = quartic + torch.nn.functional.pad(DD, (0, 2))
    # solve_quartic expects high-to-low.
    v, real = solve_quartic(quartic.flip(-1))                 # [..., 4]
    valid = real & (v > 1e-6)

    def lift(x):  # per-sample quantity -> per candidate
        return x[..., None]

    Nv = lift(N[..., 0]) + lift(N[..., 1]) * v + lift(N[..., 2]) * v * v
    Dv = lift(D[..., 0]) + lift(D[..., 1]) * v
    u = Nv / torch.where(torch.abs(Dv) < 1e-12, torch.full_like(Dv, 1e-12), Dv)
    s1sq = lift(b2) / torch.clamp(1.0 - 2.0 * lift(cb) * v + v * v, min=1e-12)
    s1 = torch.sqrt(s1sq)
    s2 = u * s1
    s3 = v * s1
    ok = valid & (s2 > 0) & (s3 > 0)
    Q = torch.stack([s1, s2, s3], dim=-1)[..., None] * f[..., None, :, :]  # [..., 4, 3, 3]
    # Absolute orientation from 3 correspondences (Horn / Procrustes).
    Xc = X[..., None, :, :]
    mx = torch.mean(Xc, dim=-2)
    mq = torch.mean(Q, dim=-2)
    H = xp.matmul((Q - mq[..., None, :]).transpose(-1, -2), Xc - mx[..., None, :])
    # The JAX SVD returns NaN for a non-finite H where LAPACK here raises:
    # such an H is zeroed for the SVD and its slot comes back NaN.
    finite = torch.isfinite(H).flatten(-2).all(dim=-1)
    R = proper_rotation(torch.where(finite[..., None, None], H, torch.zeros_like(H)))
    t = mq - xp.matvec(R, mx)
    keep = ok & finite
    nan = torch.full_like(R, float("nan"))
    return (torch.where(keep[..., None, None], R, nan),
            torch.where(keep[..., None], t, nan[..., 0]))


def p3p_ransac(
    rng: torch.Generator | torch.Tensor,
    X: torch.Tensor,     # [..., N, 3]
    pn: torch.Tensor,    # [..., N, 2]
    *,
    n_hypotheses: int = 256,
    threshold: float = 1e-4,
    data_weights: torch.Tensor | None = None,
    refine_iters: int = 8,
):
    """RANSAC resection with the P3P minimal solver (4 models a sample,
    scored in parallel), then GN refinement on the inliers.  ``rng`` is a
    ``torch.Generator`` or the sample indices ``[..., n_hypotheses, 3]``.
    Leading batch dimensions (frames) run in one dispatch.

    Returns (R [..., 3, 3], t [..., 3], inliers [..., N]).
    """
    if data_weights is None:
        data_weights = torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device)
    if isinstance(rng, torch.Generator):
        idx = sample_indices(rng, data_weights, n_hypotheses, 3)
    else:
        idx = rng
    idx = idx.to(X.device, torch.int64)                       # [..., H, 3]

    def gather(v):  # [..., N, c] -> [..., H, 3, c]
        return torch.take_along_dim(v[..., None, :, :], idx[..., None], dim=-2)

    Rs, ts = p3p(gather(X), gather(pn))                       # [..., H, 4, 3, 3]

    def sq_residuals(R, t):  # -> [..., N] for R [..., 3, 3]
        Xb = X.reshape(*X.shape[:-2], *([1] * (R.dim() - X.dim())), *X.shape[-2:])
        p = xp.matmul(Xb, R.transpose(-1, -2)) + t[..., None, :]
        pnb = pn.reshape(*pn.shape[:-2], *([1] * (R.dim() - pn.dim())), *pn.shape[-2:])
        d = torch.sum((p[..., :2] / p[..., 2:3] - pnb) ** 2, dim=-1)
        return torch.where(p[..., 2] <= 0, torch.full_like(d, 1e10), d)

    wpos = data_weights > 0
    dmask = wpos.reshape(*wpos.shape[:-1], 1, 1, wpos.shape[-1])
    inls = (sq_residuals(Rs, ts) < threshold) & dmask         # [..., H, 4, N]
    finite = torch.isfinite(Rs).flatten(-2).all(dim=-1)
    counts = torch.where(finite, torch.sum(inls, dim=-1), -1)  # [..., H, 4]
    # First maximum over the 4 candidates of a sample, then over samples.
    k = torch.argmax(counts, dim=-1)                          # [..., H]
    c_k = torch.gather(counts, -1, k[..., None])[..., 0]
    best = torch.argmax(c_k, dim=-1)                          # [...]
    kb = torch.gather(k, -1, best[..., None])[..., 0]

    def pick(v):  # [..., H, 4, *rest] -> [..., *rest] at (best, kb)
        b, pad = best.dim(), [1] * (v.dim() - best.dim())
        v = torch.take_along_dim(v, best.reshape(*best.shape, *pad), dim=b).squeeze(b)
        return torch.take_along_dim(v, kb.reshape(*kb.shape, *pad[1:]), dim=b).squeeze(b)

    R0 = torch.nan_to_num(pick(Rs), nan=0.0)
    t0 = torch.nan_to_num(pick(ts), nan=0.0)
    inliers = pick(inls)
    w_in = inliers.to(X.dtype) * data_weights
    R, t = refine_pose(R0, t0, X, pn, w_in, iters=refine_iters)
    # Re-evaluate the inliers under the refined pose.
    inliers = (sq_residuals(R, t) < threshold) & wpos
    return R, t, inliers
