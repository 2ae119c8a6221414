"""Visualization: camera frusta and point cloud, reprojection overlays,
convergence curves.

Port of :mod:`pysfm_tpu.io.viz`: host-side NumPy and matplotlib (imported
only when a plot is drawn, with the headless Agg backend).  Every function
takes the port's problems and stats; their tensors are copied to the host
first, so problems on the card plot as they are.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _require_matplotlib():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _host(x, dtype=None) -> np.ndarray:
    """A host numpy array of a tensor or array (f64 if ``dtype`` says so)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _camera_centers(R, t) -> np.ndarray:
    """World-space camera centres ``-R^T t``, [C, 3]."""
    return -np.einsum("cij,ci->cj", _host(R), _host(t))


def _frustum_corners(R, t, intr, camera_model: str, scale: float):
    """``(centres [C, 3], world-space corners of a unit-depth image
    frustum [C, 4, 3])``."""
    R, t, intr = _host(R), _host(t), _host(intr)
    C = R.shape[0]
    if camera_model == "bal":
        # f only; assume a 4:3-ish footprint in normalized coordinates.
        half_w = np.full(C, 0.5)
        half_h = np.full(C, 0.375)
        fwd = -1.0
    else:
        fx, fy, cx, cy = intr[:, 0], intr[:, 1], intr[:, 2], intr[:, 3]
        half_w = cx / fx
        half_h = cy / fy
        fwd = 1.0
    corners = np.stack(
        [
            np.stack([-half_w, -half_h, np.full(C, fwd)], -1),
            np.stack([half_w, -half_h, np.full(C, fwd)], -1),
            np.stack([half_w, half_h, np.full(C, fwd)], -1),
            np.stack([-half_w, half_h, np.full(C, fwd)], -1),
        ],
        axis=1,
    ) * scale                                              # [C, 4, 3] camera frame
    centers = _camera_centers(R, t)
    world = centers[:, None, :] + np.einsum("cij,cki->ckj", R, corners)
    return centers, world


def _save(plt, fig, path):
    if path is not None:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def draw_bundle(
    problem,
    path: Optional[str] = None,
    *,
    frustum_scale: float = 0.5,
    point_size: float = 1.0,
    max_points: int = 20000,
    elev: float = 20.0,
    azim: float = -60.0,
):
    """3-D plot of the reconstruction: camera frusta, the camera path and
    the points (a seeded sample of ``max_points`` of them).  Saves to
    ``path`` if given; returns the figure."""
    plt = _require_matplotlib()
    R = _host(problem.R, np.float64)
    t = _host(problem.t, np.float64)
    intr = _host(problem.intr, np.float64)
    X = _host(problem.X, np.float64)
    if X.shape[0] > max_points:
        sel = np.random.default_rng(0).choice(X.shape[0], max_points, replace=False)
        X = X[sel]

    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(X[:, 0], X[:, 1], X[:, 2], s=point_size, c="k", alpha=0.5)
    centers, corners = _frustum_corners(R, t, intr, problem.camera_model, frustum_scale)
    for c in range(R.shape[0]):
        for k in range(4):
            a, b = corners[c, k], corners[c, (k + 1) % 4]
            ax.plot(*np.stack([a, b]).T, c="tab:blue", lw=0.8)
            ax.plot(*np.stack([centers[c], corners[c, k]]).T, c="tab:blue", lw=0.5)
    ax.plot(*centers.T, c="tab:red", lw=1.0, marker="o", markersize=2)
    ax.view_init(elev=elev, azim=azim)
    ax.set_box_aspect((1, 1, 1))
    return _save(plt, fig, path)


def draw_reprojections(
    problem,
    camera: int,
    path: Optional[str] = None,
    *,
    image: Optional[np.ndarray] = None,
):
    """Reprojection overlay for one camera: measured (x) against projected
    (o), with the error segments."""
    plt = _require_matplotlib()
    from pysfm_tpu_torch.geometry import projection

    obs_cam = _host(problem.obs_cam)
    sel = np.flatnonzero((obs_cam == camera) & (_host(problem.obs_w) > 0))
    uv = _host(problem.obs_uv)[sel]
    pt = torch.as_tensor(_host(problem.obs_pt)[sel], device=problem.X.device).long()
    uv_hat = _host(projection.project(
        problem.camera_model, problem.R[camera], problem.t[camera],
        problem.intr[camera], problem.X[pt],
    ))
    fig, ax = plt.subplots(figsize=(8, 6))
    if image is not None:
        ax.imshow(image, cmap="gray")
    ax.scatter(uv[:, 0], uv[:, 1], marker="x", c="tab:green", s=14, label="measured")
    ax.scatter(uv_hat[:, 0], uv_hat[:, 1], marker="o", facecolors="none",
               edgecolors="tab:red", s=18, label="projected")
    for m in range(len(sel)):
        ax.plot([uv[m, 0], uv_hat[m, 0]], [uv[m, 1], uv_hat[m, 1]],
                c="tab:red", lw=0.5, alpha=0.6)
    ax.legend(loc="upper right")
    ax.set_title(f"camera {camera}: {len(sel)} observations")
    if image is None:
        ax.invert_yaxis()
    return _save(plt, fig, path)


def plot_convergence(stats, path: Optional[str] = None):
    """Cost, damping and gradient-norm curves of an ``LMStats`` record."""
    plt = _require_matplotlib()
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.2))
    axes[0].semilogy(_host(stats.costs))
    axes[0].set_title("cost")
    axes[1].semilogy(_host(stats.lams))
    axes[1].set_title("lambda")
    axes[2].semilogy(_host(stats.grad_inf))
    axes[2].set_title("|grad|_inf")
    for ax in axes:
        ax.grid(True, alpha=0.3)
    fig.tight_layout()
    return _save(plt, fig, path)
