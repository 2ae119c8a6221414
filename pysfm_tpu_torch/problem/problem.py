"""Structure-of-arrays bundle-adjustment problem state.

Port of :mod:`pysfm_tpu.problem.problem`.  The problem is a dataclass of
tensors on one device:

- cameras:      ``R [C,3,3]``, ``t [C,3]``, ``intr [C,I]``
- points:       ``X [P,3]``
- observations: ``obs_cam [M]``, ``obs_pt [M]`` (int32), ``obs_uv [M,2]``,
                ``obs_w [M]`` (confidence weight; 0 marks padding)
- visibility as padded per-point / per-camera tables ``pt_obs [P,K]``,
  ``cam_obs [C,Kc]`` (+ masks) used by the Schur elimination.

The host-side helpers (:func:`build_point_obs_table`,
:func:`prepare_problem_arrays`) are numpy and identical to the JAX
package's, so one set of inputs gives the same problem in both packages;
:func:`from_numpy` takes a JAX ``BundleProblem``'s fields as numpy arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from pysfm_tpu_torch.geometry import projection, so3
from pysfm_tpu_torch.problem import robust
from pysfm_tpu_torch.problem.robust import KERNELS as _ROBUST_KERNELS
from pysfm_tpu_torch.utils import precision as xp

# Tensor fields of BundleProblem, in declaration order.
FIELDS = (
    "R", "t", "intr", "X", "obs_cam", "obs_pt", "obs_uv", "obs_w",
    "pt_obs", "pt_obs_mask", "cam_obs", "cam_obs_mask", "cam_fixed",
    "robust_scale",
)
# Non-float fields and their numpy types (float fields take the problem dtype).
_FIELD_DTYPES = {
    "obs_cam": np.int32, "obs_pt": np.int32, "pt_obs": np.int32,
    "cam_obs": np.int32, "pt_obs_mask": bool, "cam_obs_mask": bool,
    "cam_fixed": bool,
}


@dataclasses.dataclass(frozen=True)
class BundleProblem:
    """The full BA problem state: tensors on one device + static metadata."""

    # Camera states (world-to-camera: x_cam = R @ X + t).
    R: torch.Tensor            # [C, 3, 3]
    t: torch.Tensor            # [C, 3]
    intr: torch.Tensor         # [C, I]   I = projection.INTR_DIM[camera_model]
    X: torch.Tensor            # [P, 3]
    # Observations (sorted by point id by make_problem).
    obs_cam: torch.Tensor      # [M] int32
    obs_pt: torch.Tensor       # [M] int32
    obs_uv: torch.Tensor       # [M, 2]
    obs_w: torch.Tensor        # [M] float; 0 => padding / disabled
    pt_obs: torch.Tensor       # [P, K] int32 indices into obs arrays
    pt_obs_mask: torch.Tensor  # [P, K] bool
    cam_obs: torch.Tensor      # [C, Kc] int32
    cam_obs_mask: torch.Tensor  # [C, Kc] bool
    cam_fixed: torch.Tensor    # [C] bool — gauge-fixed cameras
    robust_scale: torch.Tensor  # scalar
    camera_model: str = "pose"
    robust: str = "gaussian"

    @property
    def n_cameras(self) -> int:
        return self.R.shape[0]

    @property
    def n_points(self) -> int:
        return self.X.shape[0]

    @property
    def n_obs(self) -> int:
        return self.obs_cam.shape[0]

    @property
    def cam_dof(self) -> int:
        return projection.CAM_DOF[self.camera_model]

    @property
    def dtype(self) -> torch.dtype:
        return self.X.dtype

    @property
    def device(self) -> torch.device:
        return self.X.device

    def replace(self, **changes) -> "BundleProblem":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "BundleProblem":
        return self.replace(**{k: getattr(self, k).to(device) for k in FIELDS})


def build_point_obs_table(
    obs_pt: np.ndarray,
    n_points: int,
    max_track: Optional[int] = None,
    select: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: padded [P, K] table of observation indices per point.

    K defaults to the longest track.  Padding entries index 0 and are
    masked out.  ``select`` (bool [M]) restricts the table to a subset of
    observations (entries still index the FULL obs arrays).
    """
    obs_pt = np.asarray(obs_pt)
    ids = (
        np.arange(obs_pt.shape[0])
        if select is None
        else np.flatnonzero(select)
    )
    sub = obs_pt[ids]
    counts = np.bincount(sub, minlength=n_points)
    k = int(counts.max(initial=1)) if max_track is None else int(max_track)
    order = np.argsort(sub, kind="stable")
    sorted_pt = sub[order]
    # Rank of each observation within its point group (vectorized).
    group_start = np.zeros(n_points + 1, dtype=np.int64)
    np.cumsum(counts, out=group_start[1:])
    pos = np.arange(sub.shape[0]) - group_start[sorted_pt]
    valid = pos < k
    table = np.zeros((n_points, k), dtype=np.int32)
    mask = np.zeros((n_points, k), dtype=bool)
    table[sorted_pt[valid], pos[valid]] = ids[order[valid]]
    mask[sorted_pt[valid], pos[valid]] = True
    return table, mask


def prepare_problem_arrays(
    R,
    t,
    intr,
    X,
    obs_cam,
    obs_pt,
    obs_uv,
    *,
    camera_model: str = "pose",
    robust: str = "gaussian",
    robust_scale: float = 1.0,
    obs_w=None,
    cam_fixed=None,
    max_track: Optional[int] = None,
    max_cam_obs: Optional[int] = None,
    dtype=None,
):
    """Host-side prep: validates, sorts observations by point id, and builds
    the padded visibility tables.  Returns a dict of numpy arrays
    (+ ``dtype``, ``camera_model``, ``robust``)."""
    projection._check_model(camera_model)
    if robust not in _ROBUST_KERNELS:
        raise ValueError(f"unknown robust kernel {robust!r}")
    R = np.asarray(R)
    t = np.asarray(t)
    intr = np.asarray(intr)
    X = np.asarray(X)
    obs_cam = np.asarray(obs_cam, dtype=np.int32)
    obs_pt = np.asarray(obs_pt, dtype=np.int32)
    obs_uv = np.asarray(obs_uv)
    if dtype is None:
        dtype = obs_uv.dtype if obs_uv.dtype in (np.float32, np.float64) else np.float64
    C, P = R.shape[0], X.shape[0]
    expected_intr = projection.INTR_DIM[camera_model]
    if intr.shape != (C, expected_intr):
        raise ValueError(
            f"intr must be [{C}, {expected_intr}] for model {camera_model!r}, "
            f"got {intr.shape}"
        )
    if obs_w is None:
        obs_w = np.ones(obs_cam.shape[0])
    obs_w = np.asarray(obs_w)
    if cam_fixed is None:
        cam_fixed = np.zeros(C, dtype=bool)
        cam_fixed[0] = True  # gauge: freeze the first camera
    cam_fixed = np.asarray(cam_fixed, dtype=bool)

    # Sort by point id for segment locality; stable to keep camera order.
    order = np.argsort(obs_pt, kind="stable")
    obs_cam, obs_pt, obs_uv, obs_w = (
        obs_cam[order],
        obs_pt[order],
        obs_uv[order],
        obs_w[order],
    )
    # Zero-weight observations contribute zero to every w-scaled payload,
    # so they are excluded from the gather tables (padding would inflate K).
    live = obs_w > 0
    # max_track / max_cam_obs only bucket the table shapes upward; a value
    # below the actual maximum would silently drop observations.
    if max_track is not None and obs_pt.size:
        actual = int(np.bincount(obs_pt[live], minlength=P).max(initial=0))
        if max_track < actual:
            raise ValueError(
                f"max_track={max_track} < longest track {actual}"
            )
    if max_cam_obs is not None and obs_cam.size:
        actual = int(np.bincount(obs_cam[live], minlength=C).max(initial=0))
        if max_cam_obs < actual:
            raise ValueError(
                f"max_cam_obs={max_cam_obs} < busiest camera {actual}"
            )
    table, mask = build_point_obs_table(obs_pt, P, max_track, select=live)
    cam_table, cam_mask = build_point_obs_table(obs_cam, C, max_cam_obs,
                                                select=live)
    return dict(
        R=R, t=t, intr=intr, X=X,
        obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=obs_uv, obs_w=obs_w,
        pt_obs=table, pt_obs_mask=mask,
        cam_obs=cam_table, cam_obs_mask=cam_mask,
        cam_fixed=cam_fixed, robust_scale=robust_scale,
        camera_model=camera_model, robust=robust, dtype=dtype,
    )


def from_numpy(
    arrays: dict,
    camera_model: str,
    robust: str,
    device="cuda",
    dtype=None,
) -> BundleProblem:
    """Build the port's problem from a ``BundleProblem``'s fields given as
    numpy arrays (``arrays[name]`` for every name in :data:`FIELDS`; extra
    keys are ignored).  Float fields take ``dtype`` (default: that of
    ``arrays["X"]``); index tables are int32 and masks bool, as in the
    JAX package.  The problem goes to the card unless the caller passes
    ``device="cpu"``; without a card that raises, as torch does."""
    if dtype is None:
        dtype = np.asarray(arrays["X"]).dtype
    # np.array copies: the source may be a read-only view of a JAX array.
    return BundleProblem(
        **{
            k: torch.as_tensor(
                np.array(arrays[k], dtype=_FIELD_DTYPES.get(k, dtype)),
                device=device,
            )
            for k in FIELDS
        },
        camera_model=camera_model, robust=robust,
    )


def make_problem(*args, device="cuda", **kwargs) -> BundleProblem:
    """Host-side: sorts observations by point, builds the padded
    visibility tables, and places the problem on ``device`` (the card
    unless the caller asks for the CPU)."""
    a = prepare_problem_arrays(*args, **kwargs)
    a["robust_scale"] = np.asarray(a["robust_scale"])
    return from_numpy(a, a["camera_model"], a["robust"], device, a["dtype"])


# --------------------------------------------------------------------------
# Batched evaluation.
# --------------------------------------------------------------------------


def _gather(p: BundleProblem):
    return p.R[p.obs_cam], p.t[p.obs_cam], p.intr[p.obs_cam], p.X[p.obs_pt]


def residuals(p: BundleProblem) -> torch.Tensor:
    """Reprojection residuals r = project(cam, X) - uv, [M, 2] (unweighted)."""
    uv = projection.project(p.camera_model, *_gather(p))
    return uv - p.obs_uv


def cost(p: BundleProblem, r: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Robustified total cost 0.5 * sum_m w_m rho(||r_m||^2)."""
    if r is None:
        r = residuals(p)
    s = torch.sum(r * r, dim=-1)
    return 0.5 * torch.sum(p.obs_w * robust.rho(p.robust, s, p.robust_scale))


def residuals_and_jacobians(
    p: BundleProblem,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched residual + block-Jacobian build.

    Returns ``(r [M,2], J_cam [M,2,CP], J_pt [M,2,3], w_irls [M])`` where
    ``w_irls = obs_w * rho'(||r||^2)`` and J_cam is zeroed for gauge-fixed
    cameras.
    """
    uv, J_cam, J_pt = projection.project_with_jac(p.camera_model, *_gather(p))
    r = uv - p.obs_uv
    s = torch.sum(r * r, dim=-1)
    w = p.obs_w * robust.weight(p.robust, s, p.robust_scale)
    free = torch.logical_not(p.cam_fixed)[p.obs_cam]
    J_cam = J_cam * free[:, None, None].to(J_cam.dtype)
    return r, J_cam, J_pt, w


def apply_update(
    p: BundleProblem, d_cam: torch.Tensor, d_pt: torch.Tensor
) -> BundleProblem:
    """Retract a tangent step: R <- exp(dw) R, t += dt, intr += di, X += dX.

    ``d_cam [C, CP]`` (already zero for fixed cameras), ``d_pt [P, 3]``.
    Returns a new problem; ``p`` is not modified.
    """
    new_R = xp.matmul(so3.exp(d_cam[:, 0:3]), p.R)
    new_t = p.t + d_cam[:, 3:6]
    new_intr = p.intr + d_cam[:, 6:] if d_cam.shape[1] > 6 else p.intr
    return p.replace(R=new_R, t=new_t, intr=new_intr, X=p.X + d_pt)
