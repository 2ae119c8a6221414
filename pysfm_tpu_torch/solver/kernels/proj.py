"""Fused residual + analytic-Jacobian + robust-weight build: the CUDA kernel
(``csrc/proj.cu`` on ``csrc/project_jac.cuh``) and its plain PyTorch version.

Replaces the Pallas TPU kernel in ``pysfm_tpu/solver/kernels/pallas_proj.py``
(``residuals_jacobians_weights_cm`` and ``residuals_jacobians_weights``).
Outputs are component-major, observations on the minor axis:
``(rt [2, M], Jct [2*CP, M], Jpt [6, M], wt [M])`` — the layout the
``schur_cm`` solver consumes; the std-layout wrappers transpose.

Dispatch is by device, nothing else: for CPU tensors every wrapper runs the
plain version (:func:`proj_cm_plain`); for CUDA tensors it launches the
kernel (f32 only, as the TPU kernel) or raises.  :data:`LAUNCHES` counts
kernel launches, so a run can show that it went through the kernel.

Unlike the JAX route, the kernel gathers the camera and point rows itself
from the int32 index arrays, so the problem-level wrappers pass the tables
and never materialize the gathered ``[M, ...]`` operands.  The
JAX-signature wrappers, which take already-gathered operands, call the same
kernel with identity indices.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pysfm_tpu_torch.geometry import projection
from pysfm_tpu_torch.problem import robust as robust_mod

# Kernel launches in this process (the wrappers add one per launch).
LAUNCHES = 0

_MODEL_ID = {"pose": 0, "pose_k": 1, "bal": 2}
_ROBUST_ID = {"gaussian": 0, "huber": 1, "cauchy": 2}

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def proj_cm_plain(model, robust, R, t, intr, X, obs_cam, obs_pt, uv, w,
                  free, scale) -> Outputs:
    """Plain PyTorch version of the kernel, same arguments and outputs.

    ``R [C,3,3]``, ``t [C,3]``, ``intr [C,I]``, ``X [P,3]``, ``obs_cam`` /
    ``obs_pt [M]`` indices, ``uv [M,2]``, ``w [M]``, ``free [C]`` (1.0 for a
    free camera, 0.0 for a gauge-fixed one), ``scale`` the robust knee.
    """
    uvp, J_cam, J_pt = projection.project_with_jac(
        model, R[obs_cam], t[obs_cam], intr[obs_cam], X[obs_pt]
    )
    r = uvp - uv
    s = torch.sum(r * r, dim=-1)
    wt = w * robust_mod.weight(robust, s, scale)
    J_cam = J_cam * free[obs_cam][:, None, None]
    M = r.shape[0]
    return r.T, J_cam.reshape(M, -1).T, J_pt.reshape(M, 6).T, wt


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} is {x.dtype}; the CUDA kernel takes {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch_cm(model, robust, R, t, intr, X, obs_cam, obs_pt, uv, w, free,
               scale) -> Outputs:
    """Launch the CUDA kernel on the current stream of the tensors' device."""
    global LAUNCHES
    from pysfm_tpu_torch.solver.kernels import _build

    dev = uv.device
    f32, i32 = torch.float32, torch.int32
    C, P, M = R.shape[0], X.shape[0], uv.shape[0]
    cp = projection.CAM_DOF[model]
    _check("R", R, f32, (C, 3, 3), dev)
    _check("t", t, f32, (C, 3), dev)
    _check("intr", intr, f32, (C, projection.INTR_DIM[model]), dev)
    _check("X", X, f32, (P, 3), dev)
    _check("obs_cam", obs_cam, i32, (M,), dev)
    _check("obs_pt", obs_pt, i32, (M,), dev)
    _check("uv", uv, f32, (M, 2), dev)
    _check("w", w, f32, (M,), dev)
    _check("free", free, f32, (C,), dev)
    _check("scale", scale, f32, (), dev)
    if M > 2**31 - 256:
        raise ValueError(f"M={M} overflows the kernel's int32 observation index")

    rt = torch.empty((2, M), dtype=f32, device=dev)
    Jct = torch.empty((2 * cp, M), dtype=f32, device=dev)
    Jpt = torch.empty((6, M), dtype=f32, device=dev)
    wt = torch.empty((M,), dtype=f32, device=dev)
    if M == 0:
        return rt, Jct, Jpt, wt
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pysfm_proj_cm(
            _MODEL_ID[model], _ROBUST_ID[robust],
            R.data_ptr(), t.data_ptr(), intr.data_ptr(), X.data_ptr(),
            obs_cam.data_ptr(), obs_pt.data_ptr(), uv.data_ptr(), w.data_ptr(),
            free.data_ptr(), scale.data_ptr(), M,
            rt.data_ptr(), Jct.data_ptr(), Jpt.data_ptr(), wt.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"pysfm_proj_cm launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return rt, Jct, Jpt, wt


def _proj_cm(model, robust, *args) -> Outputs:
    projection._check_model(model)
    robust_mod._check(robust)
    device = args[6].device  # uv
    if device.type == "cpu":
        return proj_cm_plain(model, robust, *args)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    return _launch_cm(model, robust, *args)


def residuals_jacobians_weights_cm(model, robust, Rg, tg, ig, Xg, obs_uv,
                                   obs_w, free, robust_scale) -> Outputs:
    """JAX-signature entry (``pallas_proj.residuals_jacobians_weights_cm``):
    gathered operands ``Rg [M,3,3]``, ``tg [M,3]``, ``ig [M,I]``,
    ``Xg [M,3]``, ``free [M]``; runs the kernel with identity indices."""
    M = obs_uv.shape[0]
    idx = torch.arange(M, dtype=torch.int32, device=obs_uv.device)
    scale = torch.as_tensor(robust_scale, dtype=obs_uv.dtype, device=obs_uv.device)
    return _proj_cm(model, robust, Rg, tg, ig, Xg, idx, idx, obs_uv, obs_w,
                    free.to(obs_uv.dtype), scale)


def _to_std(rt, Jct, Jpt, wt):
    M = wt.shape[0]
    return rt.T, Jct.T.reshape(M, 2, -1), Jpt.T.reshape(M, 2, 3), wt


def residuals_jacobians_weights(model, robust, Rg, tg, ig, Xg, obs_uv,
                                obs_w, free, robust_scale) -> Outputs:
    """JAX-signature std-layout entry
    (``pallas_proj.residuals_jacobians_weights``): ``(r [M,2],
    J_cam [M,2,CP], J_pt [M,2,3], w [M])``."""
    return _to_std(*residuals_jacobians_weights_cm(
        model, robust, Rg, tg, ig, Xg, obs_uv, obs_w, free, robust_scale
    ))


def _problem_args(p):
    free = torch.logical_not(p.cam_fixed).to(p.dtype)
    return (p.R, p.t, p.intr, p.X, p.obs_cam, p.obs_pt, p.obs_uv, p.obs_w,
            free, p.robust_scale)


def residuals_and_jacobians_cm(p) -> Outputs:
    """Component-major build for a :class:`BundleProblem`: ``(rt [2,M],
    Jct [2CP,M], Jpt [6,M], wt [M])`` for the schur_cm solver.  The kernel
    gathers the camera and point rows itself."""
    return _proj_cm(p.camera_model, p.robust, *_problem_args(p))


def residuals_and_jacobians(p) -> Outputs:
    """Kernel-backed drop-in for
    :func:`pysfm_tpu_torch.problem.problem.residuals_and_jacobians`."""
    return _to_std(*residuals_and_jacobians_cm(p))
