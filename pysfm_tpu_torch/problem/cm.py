"""Component-major (CM) problem layout: the pcg route's problem state.

Port of :mod:`pysfm_tpu.problem.cm`.  :class:`CMProblem` holds the same
information as :class:`~pysfm_tpu_torch.problem.BundleProblem` with every
observation- or point-sized quantity stored with the big axis minor: points
as ``X3 [3, P]``, measurements as flat ``u [M]`` / ``v [M]`` vectors, the
per-point visibility table transposed to ``[K, P]``.  Camera-sized arrays
keep the standard layout.  The JAX package chose this layout for the TPU's
(8, 128) tiling; the port keeps it because the pcg route's functions and
their tests are written against it, and because ``[D, M]`` rows are what a
CUDA thread per observation reads and writes coalesced.

The projection math here is unrolled over component rows (every
intermediate an ``[m]`` vector), as in the JAX module; it is the plain
twin of the device function in ``csrc/project_jac.cuh``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from pysfm_tpu_torch.geometry import projection, so3
from pysfm_tpu_torch.problem import problem as problem_mod
from pysfm_tpu_torch.utils import precision as xp

# Tensor fields of CMProblem, in declaration order.
FIELDS = (
    "R", "t", "intr", "cam_fixed", "X3", "obs_cam", "obs_pt", "u", "v",
    "obs_w", "pt_obsT", "pt_obs_maskT", "cam_obs", "cam_obs_mask",
    "robust_scale",
)
# Non-float fields and their numpy types (float fields take the problem dtype).
_FIELD_DTYPES = {
    "cam_fixed": bool, "obs_cam": np.int32, "obs_pt": np.int32,
    "pt_obsT": np.int32, "pt_obs_maskT": bool, "cam_obs": np.int32,
    "cam_obs_mask": bool,
}


@dataclasses.dataclass(frozen=True)
class CMProblem:
    """Bundle-adjustment state in component-major layout."""

    # Camera states (C is small: standard layout).
    R: torch.Tensor            # [C, 3, 3]
    t: torch.Tensor            # [C, 3]
    intr: torch.Tensor         # [C, I]
    cam_fixed: torch.Tensor    # [C] bool
    # Points, component-major.
    X3: torch.Tensor           # [3, P]
    # Observations (sorted by point id), flat vectors.
    obs_cam: torch.Tensor      # [M] int32
    obs_pt: torch.Tensor       # [M] int32
    u: torch.Tensor            # [M] measured pixel u
    v: torch.Tensor            # [M] measured pixel v
    obs_w: torch.Tensor        # [M]; 0 => padding / disabled
    # Visibility tables: point side transposed (P minor), camera side
    # standard.
    pt_obsT: torch.Tensor       # [K, P] int32 indices into obs arrays
    pt_obs_maskT: torch.Tensor  # [K, P] bool
    cam_obs: torch.Tensor       # [C, Kc] int32
    cam_obs_mask: torch.Tensor  # [C, Kc] bool
    robust_scale: torch.Tensor  # scalar
    camera_model: str = "pose"
    robust: str = "gaussian"

    @property
    def n_cameras(self) -> int:
        return self.R.shape[0]

    @property
    def n_points(self) -> int:
        return self.X3.shape[1]

    @property
    def n_obs(self) -> int:
        return self.obs_cam.shape[0]

    @property
    def cam_dof(self) -> int:
        return projection.CAM_DOF[self.camera_model]

    @property
    def dtype(self) -> torch.dtype:
        return self.X3.dtype

    @property
    def device(self) -> torch.device:
        return self.X3.device

    def replace(self, **changes) -> "CMProblem":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "CMProblem":
        return self.replace(**{k: getattr(self, k).to(device) for k in FIELDS})


def from_numpy(
    arrays: dict,
    camera_model: str,
    robust: str,
    device="cuda",
    dtype=None,
) -> CMProblem:
    """Build the port's CMProblem from a JAX ``CMProblem``'s fields given as
    numpy arrays (``arrays[name]`` for every name in :data:`FIELDS`; extra
    keys are ignored).  Float fields take ``dtype`` (default: that of
    ``arrays["X3"]``).  The problem goes to the card unless the caller
    passes ``device="cpu"``."""
    if dtype is None:
        dtype = np.asarray(arrays["X3"]).dtype
    return CMProblem(
        **{
            k: torch.as_tensor(
                np.array(arrays[k], dtype=_FIELD_DTYPES.get(k, dtype), order="C"),
                device=device,
            )
            for k in FIELDS
        },
        camera_model=camera_model, robust=robust,
    )


def make_cm_problem(*args, device="cuda", **kwargs) -> CMProblem:
    """Host-side counterpart of :func:`problem.make_problem` that emits
    the component-major layout directly (the standard layout's arrays never
    reach the device)."""
    a = problem_mod.prepare_problem_arrays(*args, **kwargs)
    uv = np.asarray(a["obs_uv"], dtype=a["dtype"])
    arrays = dict(
        R=a["R"], t=a["t"], intr=a["intr"], cam_fixed=a["cam_fixed"],
        X3=np.asarray(a["X"]).T, obs_cam=a["obs_cam"], obs_pt=a["obs_pt"],
        u=uv[:, 0], v=uv[:, 1], obs_w=a["obs_w"],
        pt_obsT=a["pt_obs"].T, pt_obs_maskT=a["pt_obs_mask"].T,
        cam_obs=a["cam_obs"], cam_obs_mask=a["cam_obs_mask"],
        robust_scale=np.asarray(a["robust_scale"]),
    )
    return from_numpy(arrays, a["camera_model"], a["robust"], device, a["dtype"])


def from_problem(p: problem_mod.BundleProblem) -> CMProblem:
    """Conversion from the standard layout on the problem's device (one
    transpose of the point and observation arrays)."""
    return CMProblem(
        R=p.R, t=p.t, intr=p.intr, cam_fixed=p.cam_fixed,
        X3=p.X.T.contiguous(),
        obs_cam=p.obs_cam, obs_pt=p.obs_pt,
        u=p.obs_uv[:, 0].contiguous(), v=p.obs_uv[:, 1].contiguous(),
        obs_w=p.obs_w,
        pt_obsT=p.pt_obs.T.contiguous(),
        pt_obs_maskT=p.pt_obs_mask.T.contiguous(),
        cam_obs=p.cam_obs, cam_obs_mask=p.cam_obs_mask,
        robust_scale=p.robust_scale,
        camera_model=p.camera_model, robust=p.robust,
    )


def merge_params(
    p: problem_mod.BundleProblem, cmp: CMProblem
) -> problem_mod.BundleProblem:
    """Write a solved CMProblem's parameters back into a standard-layout
    problem (the measurement arrays are identical by construction)."""
    return p.replace(R=cmp.R, t=cmp.t, intr=cmp.intr, X=cmp.X3.T.contiguous())


# --------------------------------------------------------------------------
# Camera parameter table + component-major projection math.
#
# The camera table packs everything an observation needs from its camera
# into one [Dc, C] array: rows 0..8 = R row-major, 9..11 = t,
# 12..12+I-1 = intr, last row = free flag (0 for gauge-fixed cameras;
# multiplies J_cam).  The CUDA kernels read the same table.
# --------------------------------------------------------------------------


def cam_table(cmp: CMProblem) -> torch.Tensor:
    """[Dc, C] packed camera parameters (see the note above)."""
    C = cmp.n_cameras
    dt = cmp.dtype
    free = torch.logical_not(cmp.cam_fixed).to(dt)[None, :]      # [1, C]
    return torch.cat(
        [cmp.R.reshape(C, 9).T.to(dt), cmp.t.T.to(dt), cmp.intr.T.to(dt), free],
        dim=0,
    )


def _cam_point_cm(cols, Xg):
    """p = R X + t from gathered camera columns; returns (x, y, z, rx, ry,
    rz) with r = R X (needed for the -hat(RX) pose block)."""
    X0, X1, X2 = Xg[0], Xg[1], Xg[2]
    rx = cols[0] * X0 + cols[1] * X1 + cols[2] * X2
    ry = cols[3] * X0 + cols[4] * X1 + cols[5] * X2
    rz = cols[6] * X0 + cols[7] * X1 + cols[8] * X2
    return rx + cols[9], ry + cols[10], rz + cols[11], rx, ry, rz


def project_cm(model: str, cols, Xg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Projection on component rows: ``cols [Dc, m]``, ``Xg [3, m]`` ->
    ``(u, v)``, each ``[m]``."""
    projection._check_model(model)
    x, y, z, _, _, _ = _cam_point_cm(cols, Xg)
    inv_z = 1.0 / z
    if model == "bal":
        f, k1, k2 = cols[12], cols[13], cols[14]
        pn0 = -x * inv_z
        pn1 = -y * inv_z
        r2 = pn0 * pn0 + pn1 * pn1
        rho = 1.0 + r2 * (k1 + r2 * k2)
        return f * rho * pn0, f * rho * pn1
    # Same operation order as project_jac_cm, so the two agree bitwise.
    fx, fy, cx, cy = cols[12], cols[13], cols[14], cols[15]
    return fx * (x * inv_z) + cx, fy * (y * inv_z) + cy


def project_jac_cm(
    model: str, cols, Xg
) -> Tuple[torch.Tensor, torch.Tensor, List[List[torch.Tensor]], List[List[torch.Tensor]]]:
    """Projection + analytic Jacobians on component rows.

    Returns ``(u, v, Jc, Jp)`` where ``Jc[i][d]`` (residual component i,
    camera dof d) and ``Jp[i][s]`` (s < 3) are ``[m]`` vectors.  The gauge
    free-flag row of ``cols`` multiplies every Jc entry."""
    projection._check_model(model)
    x, y, z, rx, ry, rz = _cam_point_cm(cols, Xg)
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    free = cols[-1]

    if model == "bal":
        f, k1, k2 = cols[12], cols[13], cols[14]
        pn0 = -x * inv_z
        pn1 = -y * inv_z
        r2 = pn0 * pn0 + pn1 * pn1
        rho = 1.0 + r2 * (k1 + r2 * k2)
        u = f * rho * pn0
        v = f * rho * pn1
        # duv_dpn = f (rho I + pn drho^T), drho = (2 k1 + 4 k2 r2) pn.
        g = 2.0 * k1 + 4.0 * k2 * r2
        dr0 = g * pn0
        dr1 = g * pn1
        a00 = f * (rho + pn0 * dr0)
        a01 = f * (pn0 * dr1)
        a10 = f * (pn1 * dr0)
        a11 = f * (rho + pn1 * dr1)
        # dpn_dp = [[-iz, 0, x iz^2], [0, -iz, y iz^2]]
        d = [
            [-a00 * inv_z, -a01 * inv_z, (a00 * x + a01 * y) * inv_z2],
            [-a10 * inv_z, -a11 * inv_z, (a10 * x + a11 * y) * inv_z2],
        ]
        J_intr = [
            [rho * pn0, f * r2 * pn0, f * r2 * r2 * pn0],
            [rho * pn1, f * r2 * pn1, f * r2 * r2 * pn1],
        ]
    else:
        fx, fy = cols[12], cols[13]
        pn0 = x * inv_z
        pn1 = y * inv_z
        u = fx * pn0 + cols[14]
        v = fy * pn1 + cols[15]
        zero = torch.zeros_like(x)
        d = [
            [fx * inv_z, zero, -fx * x * inv_z2],
            [zero, fy * inv_z, -fy * y * inv_z2],
        ]
        if model == "pose_k":
            one = torch.ones_like(x)
            J_intr = [[pn0, zero, one, zero], [zero, pn1, zero, one]]
        else:
            J_intr = None

    # dp/ddw = -hat(R X); dp/ddt = I; dp/dX = R.
    Jc: List[List[torch.Tensor]] = [[], []]
    Jp: List[List[torch.Tensor]] = [[], []]
    for i in range(2):
        d0, d1, d2 = d[i]
        Jw = [-d1 * rz + d2 * ry, d0 * rz - d2 * rx, -d0 * ry + d1 * rx]
        block = Jw + [d0, d1, d2] + (J_intr[i] if J_intr is not None else [])
        Jc[i] = [free * e for e in block]
        Jp[i] = [
            d0 * cols[0] + d1 * cols[3] + d2 * cols[6],
            d0 * cols[1] + d1 * cols[4] + d2 * cols[7],
            d0 * cols[2] + d1 * cols[5] + d2 * cols[8],
        ]
    return u, v, Jc, Jp


def apply_update_cm(
    cmp: CMProblem, d_cam: torch.Tensor, d_pt3: torch.Tensor
) -> CMProblem:
    """Retraction in the CM domain: ``d_cam [C, CP]`` (standard layout),
    ``d_pt3 [3, P]`` component-major.  Returns a new problem."""
    new_R = xp.matmul(so3.exp(d_cam[:, 0:3]), cmp.R)
    new_t = cmp.t + d_cam[:, 3:6]
    new_intr = cmp.intr + d_cam[:, 6:] if d_cam.shape[1] > 6 else cmp.intr
    return cmp.replace(R=new_R, t=new_t, intr=new_intr, X3=cmp.X3 + d_pt3)
