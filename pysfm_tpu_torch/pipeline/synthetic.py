"""Synthetic ground-truth scene generation.

Port of ``look_at_rotation``, ``SyntheticScene``, ``make_scene`` and
``make_bal_scene`` from :mod:`pysfm_tpu.pipeline.synthetic`: random points
in a box, cameras on a ring looking at them, exact projections plus optional
noise and outliers, then a perturbed initial guess.  The numpy generator is
drawn from in the same order as the JAX package, so one seed gives the same
scene; the exact projections are computed in f64 and cast to ``dtype`` by
the problem constructors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pysfm_tpu_torch.geometry import projection, so3
from pysfm_tpu_torch.problem import BundleProblem, make_problem


def look_at_rotation(center: np.ndarray, target: np.ndarray, flip_z: bool) -> np.ndarray:
    """World->camera rotation for a camera at ``center`` looking at ``target``.

    ``flip_z=False``: +z forward (pinhole models).  ``flip_z=True``: -z
    forward (BAL convention).  Rows of R are the camera axes in world
    coordinates.
    """
    fwd = target - center
    fwd = fwd / np.linalg.norm(fwd)
    z = -fwd if flip_z else fwd
    up = np.array([0.0, 1.0, 0.0])
    if abs(np.dot(up, z)) > 0.99:
        up = np.array([1.0, 0.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=0)


@dataclass
class SyntheticScene:
    """Ground truth + a perturbed problem ready for the solver."""

    truth: BundleProblem      # exact parameters, zero-residual measurements
    problem: BundleProblem    # perturbed initial guess (same measurements)
    noise_px: float
    outlier_frac: float


def _ring_cameras(rng, n_cameras, camera_model, radius):
    """Cameras on a ring looking at the origin, and their intrinsics; draws
    from ``rng`` in the JAX package's order (centre heights, then BAL focal
    lengths)."""
    flip_z = camera_model == "bal"
    angles = 2.0 * np.pi * np.arange(n_cameras) / max(n_cameras, 3)
    centers = np.stack(
        [
            radius * np.cos(angles),
            0.5 * rng.normal(size=n_cameras),
            radius * np.sin(angles),
        ],
        axis=-1,
    )
    R = np.stack(
        [look_at_rotation(c, np.zeros(3), flip_z) for c in centers], axis=0
    )
    t = -np.einsum("cij,cj->ci", R, centers)
    if camera_model == "bal":
        intr = np.stack(
            [
                800.0 + 10.0 * rng.normal(size=n_cameras),
                np.full(n_cameras, 1e-4),
                np.full(n_cameras, 1e-7),
            ],
            axis=-1,
        )
    else:
        intr = np.stack(
            [
                np.full(n_cameras, 800.0),
                np.full(n_cameras, 800.0),
                np.full(n_cameras, 320.0),
                np.full(n_cameras, 240.0),
            ],
            axis=-1,
        )
    return R, t, intr


def make_bal_scene(
    n_cameras: int = 1712,
    n_points: int = 1_000_000,
    *,
    mean_track: float = 5.0,
    max_track: int = 12,
    camera_model: str = "pose",
    robust: str = "gaussian",
    robust_scale: float = 1.0,
    noise_px: float = 0.0,
    outlier_frac: float = 0.0,
    outlier_px: float = 50.0,
    perturb_rot: float = 0.01,
    perturb_trans: float = 0.02,
    perturb_point: float = 0.02,
    radius: float = 10.0,
    seed: int = 0,
    dtype=np.float32,
    with_truth: bool = True,
    layout: str = "std",
    device="cuda",
) -> SyntheticScene:
    """BAL/Venice-scale scene (1.7k cameras, 1M points by default).

    Port of :func:`pysfm_tpu.pipeline.synthetic.make_bal_scene`, same draw
    order.  Each point draws a track length in [2, max_track] (mean
    ``mean_track``) and observes a contiguous window of cameras on the ring,
    so the all-pairs visibility grid never exists.  ``with_truth=False``
    skips the ground-truth problem; ``layout="cm"`` emits
    :class:`~pysfm_tpu_torch.problem.cm.CMProblem` instead of
    :class:`BundleProblem`.  The exact projections are computed in f64 on
    ``device`` (the card unless the caller asks for the CPU), where the
    problems are placed too.
    """
    if layout not in ("std", "cm"):
        raise ValueError(f"unknown layout {layout!r}")
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, size=(n_points, 3))
    R, t, intr = _ring_cameras(rng, n_cameras, camera_model, radius)

    # Track lengths: 2 + Poisson(mean - 2), clipped to max_track; window
    # start per point, slots index consecutive cameras (mod C).
    k = 2 + rng.poisson(max(mean_track - 2.0, 0.0), size=n_points)
    k = np.minimum(k, max_track)
    start = rng.integers(0, n_cameras, size=n_points)
    pt_idx = np.repeat(np.arange(n_points, dtype=np.int64), k)
    offs = np.arange(max_track)
    grid_mask = offs[None, :] < k[:, None]                  # [P, max_track]
    cam_grid = (start[:, None] + offs[None, :]) % n_cameras
    cam_idx = cam_grid[grid_mask].astype(np.int64)

    # Exact projections, in chunks, with the small camera and point tables
    # on the device and the gathers done there.
    M = cam_idx.shape[0]
    uv = np.empty((M, 2), dtype=np.float64)
    Rd, td, intrd, Xd = (torch.from_numpy(a).to(device) for a in (R, t, intr, X))
    chunk = 1 << 20
    for lo in range(0, M, chunk):
        hi = min(lo + chunk, M)
        ci = torch.from_numpy(cam_idx[lo:hi]).to(device)
        pi = torch.from_numpy(pt_idx[lo:hi]).to(device)
        uv[lo:hi] = projection.project(
            camera_model, Rd[ci], td[ci], intrd[ci], Xd[pi]
        ).cpu().numpy()
    if noise_px > 0:
        uv += rng.normal(scale=noise_px, size=uv.shape)
    if outlier_frac > 0:
        n_out = int(outlier_frac * M)
        which = rng.choice(M, size=n_out, replace=False)
        uv[which] += rng.uniform(-outlier_px, outlier_px, size=(n_out, 2))

    if layout == "cm":
        from pysfm_tpu_torch.problem.cm import make_cm_problem as make
    else:
        make = make_problem
    common = dict(
        camera_model=camera_model, robust=robust, robust_scale=robust_scale,
        dtype=dtype, device=device,
    )
    truth = (
        make(R, t, intr, X, cam_idx, pt_idx, uv, **common)
        if with_truth else None
    )

    dw = rng.normal(scale=perturb_rot, size=(n_cameras, 3))
    dw[0] = 0.0
    dt = rng.normal(scale=perturb_trans, size=(n_cameras, 3))
    dt[0] = 0.0
    R_pert = so3.exp(torch.from_numpy(dw)).numpy() @ R
    t_pert = t + dt
    X_pert = X + rng.normal(scale=perturb_point, size=X.shape)
    problem = make(R_pert, t_pert, intr, X_pert, cam_idx, pt_idx, uv, **common)
    return SyntheticScene(
        truth=truth, problem=problem, noise_px=noise_px, outlier_frac=outlier_frac
    )


def make_scene(
    n_cameras: int = 2,
    n_points: int = 100,
    *,
    camera_model: str = "pose",
    robust: str = "gaussian",
    robust_scale: float = 1.0,
    noise_px: float = 0.0,
    outlier_frac: float = 0.0,
    outlier_px: float = 50.0,
    perturb_rot: float = 0.02,
    perturb_trans: float = 0.05,
    perturb_point: float = 0.05,
    visibility: float = 1.0,
    radius: float = 10.0,
    seed: int = 0,
    dtype=np.float64,
    device="cuda",
) -> SyntheticScene:
    """Cameras on a ring of ``radius`` looking at a unit-ish point cloud.

    ``visibility`` < 1 drops a random subset of (camera, point) pairs so the
    visibility graph is irregular.  Both problems are placed on ``device``
    (the card unless the caller asks for the CPU).
    """
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, size=(n_points, 3))
    R, t, intr = _ring_cameras(rng, n_cameras, camera_model, radius)

    # All pairs, thinned by `visibility`; every point keeps >= 2 views so it
    # stays constrained.
    cam_idx, pt_idx = np.meshgrid(
        np.arange(n_cameras), np.arange(n_points), indexing="ij"
    )
    cam_idx, pt_idx = cam_idx.ravel(), pt_idx.ravel()
    if visibility < 1.0:
        keep = rng.random(cam_idx.shape[0]) < visibility
        # Force the first two cameras of every point to stay.
        keep |= cam_idx < 2
        cam_idx, pt_idx = cam_idx[keep], pt_idx[keep]

    uv = projection.project(
        camera_model,
        torch.from_numpy(R[cam_idx]),
        torch.from_numpy(t[cam_idx]),
        torch.from_numpy(intr[cam_idx]),
        torch.from_numpy(X[pt_idx]),
    ).numpy()
    if noise_px > 0:
        uv = uv + rng.normal(scale=noise_px, size=uv.shape)
    if outlier_frac > 0:
        n_out = int(outlier_frac * uv.shape[0])
        which = rng.choice(uv.shape[0], size=n_out, replace=False)
        uv[which] += rng.uniform(-outlier_px, outlier_px, size=(n_out, 2))

    common = dict(
        camera_model=camera_model,
        robust=robust,
        robust_scale=robust_scale,
        dtype=dtype,
        device=device,
    )
    truth = make_problem(R, t, intr, X, cam_idx, pt_idx, uv, **common)

    # Perturb everything except the gauge-fixed camera 0.
    dw = rng.normal(scale=perturb_rot, size=(n_cameras, 3))
    dw[0] = 0.0
    dt = rng.normal(scale=perturb_trans, size=(n_cameras, 3))
    dt[0] = 0.0
    R_pert = so3.exp(torch.from_numpy(dw)).numpy() @ R
    t_pert = t + dt
    X_pert = X + rng.normal(scale=perturb_point, size=X.shape)
    problem = make_problem(
        R_pert, t_pert, intr, X_pert, cam_idx, pt_idx, uv, **common
    )
    return SyntheticScene(
        truth=truth, problem=problem, noise_px=noise_px, outlier_frac=outlier_frac
    )


PLAN_EDGES = ("random", "empty_and_long_cameras", "point_seen_by_every_camera",
              "x_too_large_for_shared_memory")


def plan_edge_incidence(kind: str, seed: int = 7):
    """A visibility pattern ``(obs_cam, obs_pt, C, P)`` (int32, sorted by
    point) at one edge of the plans of the CG products
    (``solver/kernels/spmv.py``), one of :data:`PLAN_EDGES`:

    - ``random``: 7 cameras, 60 points, 2-4 cameras a point;
    - ``empty_and_long_cameras``: cameras 0 and 1 see every point (more than
      one ``hcp_w`` chunk each), camera 3 every tenth, cameras 2 and 4
      nothing;
    - ``point_seen_by_every_camera``: point 7 is seen by all cameras (longer
      than one ``hcpT_x`` tile), point 8 by 700 (longer than half a tile,
      alone in its tile), point 9 by none;
    - ``x_too_large_for_shared_memory``: 6000 cameras, so that ``x [CP, C]``
      (240 KB at CP = 10) does not fit in one block's shared memory on an
      H100 (227 KB); 5000 points, 2-5 cameras each.
    """
    from pysfm_tpu_torch.solver.kernels import spmv

    rng = np.random.default_rng(seed)
    pairs = []
    if kind == "random":
        C, P = 7, 60
        for p in range(P):
            pairs += [(c, p) for c in rng.choice(C, size=2 + rng.integers(3), replace=False)]
    elif kind == "empty_and_long_cameras":
        C, P = 5, spmv.HCP_W_CHUNK + 476
        for p in range(P):
            pairs += [(0, p), (1, p)] + ([(3, p)] if p % 10 == 0 else [])
    elif kind == "point_seen_by_every_camera":
        C, P = spmv.HCPT_X_TILE + 276, 40
        for p in range(P):
            if p == 7:
                cams = np.arange(C)
            elif p == 8:
                cams = np.sort(rng.choice(C, size=700, replace=False))
            elif p == 9:
                cams = []
            else:
                cams = rng.choice(C, size=2 + rng.integers(3), replace=False)
            pairs += [(c, p) for c in cams]
    elif kind == "x_too_large_for_shared_memory":
        C, P = 6000, 5000
        for p in range(P):
            pairs += [(c, p) for c in rng.choice(C, size=2 + rng.integers(4), replace=False)]
    else:
        raise ValueError(f"kind={kind!r}: one of {PLAN_EDGES}")
    obs_cam, obs_pt = np.asarray(pairs, np.int64).T
    return obs_cam.astype(np.int32), obs_pt.astype(np.int32), C, P


def plan_edge_scene(
    kind: str,
    *,
    camera_model: str = "pose",
    robust: str = "huber",
    robust_scale: float = 2.0,
    noise_px: float = 1.0,
    outlier_frac: float = 0.05,
    outlier_px: float = 40.0,
    perturb: float = 0.02,
    seed: int = 7,
    dtype=np.float32,
    device="cuda",
):
    """A :class:`~pysfm_tpu_torch.problem.cm.CMProblem` on the observations
    of :func:`plan_edge_incidence` (``kind``, ``seed``): cameras on a ring
    (radius 10) and points in a box, both perturbed, measurements from the
    exact projections plus noise and outliers.  The scene on which the
    normal-equation build is checked at the plans' edges (empty cameras,
    cameras with more than one chunk, a point seen by every camera)."""
    obs_cam, obs_pt, C, P = plan_edge_incidence(kind, seed)
    rng = np.random.default_rng(seed + 1)
    X = rng.uniform(-2.0, 2.0, size=(P, 3))
    R, t, intr = _ring_cameras(rng, C, camera_model, 10.0)
    ci, pi = obs_cam.astype(np.int64), obs_pt.astype(np.int64)
    uv = projection.project(
        camera_model, *(torch.from_numpy(a) for a in (R[ci], t[ci], intr[ci], X[pi]))
    ).numpy()
    uv += rng.normal(scale=noise_px, size=uv.shape)
    n_out = int(outlier_frac * uv.shape[0])
    which = rng.choice(uv.shape[0], size=n_out, replace=False)
    uv[which] += rng.uniform(-outlier_px, outlier_px, size=(n_out, 2))
    R = so3.exp(torch.from_numpy(rng.normal(scale=perturb, size=(C, 3)))).numpy() @ R
    X = X + rng.normal(scale=perturb, size=X.shape)
    from pysfm_tpu_torch.problem.cm import make_cm_problem

    return make_cm_problem(R, t, intr, X, obs_cam, obs_pt, uv, camera_model=camera_model,
                           robust=robust, robust_scale=robust_scale, dtype=dtype,
                           device=device)
