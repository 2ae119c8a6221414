"""Typed LM configuration, field for field the JAX package's ``LMConfig``
(``pysfm_tpu/utils/config.py``) so one config means one solve in both."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Levenberg-Marquardt settings."""

    max_iters: int = 50
    # Initial damping and Nielsen trust-region constants.
    lam0: float = 1e-4
    lam_min: float = 1e-12
    lam_max: float = 1e10
    # Convergence: infinity-norm of the gradient, relative cost decrease,
    # and step norm.
    tol_grad: float = 1e-10
    tol_cost_rel: float = 1e-12
    tol_step: float = 1e-12
    # Re-orthonormalize rotations every k accepted steps (0 = never);
    # fights f32 drift of the multiplicative updates.
    renormalize_every: int = 0
    # Reduced-camera-system solver: "dense" materializes the [C*CP, C*CP]
    # Schur complement; "pcg" solves it matrix-free with preconditioned CG
    # on the component-major route (solver/pcg.py).
    solver: str = "dense"
    cg_iters: int = 100
    cg_tol: float = 1e-6
    # Observation-chunked Jacobian build for the pcg route without kernel
    # operands: chunks of obs_chunk observations (0 = chunks of 2^18, as the
    # JAX package's code does).
    obs_chunk: int = 0
    # Residual/Jacobian/robust-weight build: "torch" (plain PyTorch),
    # "cuda" (the hand-written kernel, CUDA f32 only — raises otherwise),
    # or "auto" (the kernel iff the problem lives on a CUDA device in f32,
    # the rule the JAX package applies to its TPU kernel).
    jac_backend: str = "auto"
    # Dense solver data layout: "cm" (component-major [D, M] rows, see
    # solver/schur_cm.py), "std" ([M, 2, CP] blocks, solver/schur.py) or
    # "auto" (cm).
    layout: str = "auto"
    # pcg route: warm-start CG with the previous camera step; the CG
    # tolerance sequence ("fixed" cg_tol, or "ew": Eisenstat-Walker forcing
    # between cg_tol and cg_tol_max); quadratic-model stagnation stop
    # (0 = off); reuse the linearization after a rejected step; terms of
    # the power-series preconditioner (1 = block-Jacobi).  The dense route
    # does not read them.
    cg_warm_start: bool = True
    cg_forcing: str = "fixed"
    cg_tol_max: float = 0.3
    cg_q_tol: float = 0.0
    reuse_linearization: bool = True
    cg_precond_terms: int = 1
