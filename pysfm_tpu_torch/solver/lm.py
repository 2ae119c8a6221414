"""Levenberg-Marquardt bundle adjustment: the dense component-major route.

Port of ``pysfm_tpu.solver.lm.solve`` / ``_solve_std`` (the ``layout="cm"``
branch, which ``LMConfig()`` selects by default).  Each iteration builds the
residuals, Jacobians and IRLS weights (the CUDA kernel in
:mod:`~pysfm_tpu_torch.solver.kernels.proj`, or plain PyTorch), the
component-major normal equations, the damped Schur step, and the candidate's
cost; accept/reject is predicated (``torch.where`` on the candidate) and the
damping follows Nielsen's schedule, exactly as the JAX loop.

The JAX package runs this loop inside one ``lax.while_loop``.  Here it is a
host loop over device tensors: the only host read per iteration is the
``done`` flag (one scalar), which decides whether to stop early.  Removing
it (CUDA graph capture of the iteration) is later work.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from pysfm_tpu_torch.geometry import so3
from pysfm_tpu_torch.problem import problem as problem_mod
from pysfm_tpu_torch.problem.problem import BundleProblem
from pysfm_tpu_torch.solver import schur_cm
from pysfm_tpu_torch.solver.kernels import proj
from pysfm_tpu_torch.utils.config import LMConfig


@dataclasses.dataclass
class LMStats:
    """Per-iteration log, kept on the problem's device (same fields as the
    JAX package's ``LMStats``)."""

    costs: torch.Tensor       # [max_iters + 1]; costs[0] = initial, then cost
                              # after each iteration (accepted or kept)
    lams: torch.Tensor        # [max_iters] damping used at each iteration
    accepted: torch.Tensor    # [max_iters] bool
    grad_inf: torch.Tensor    # [max_iters] inf-norm of the gradient
    step_norms: torch.Tensor  # [max_iters]
    n_iters: torch.Tensor     # scalar int: iterations actually executed
    lam_next: torch.Tensor    # damping state AFTER the last iteration
    nu_next: torch.Tensor     # Nielsen growth state after the last iteration
    cg_iters: torch.Tensor    # [max_iters] int: CG iterations (0 on this route)
    dc_next: torch.Tensor     # [C, CP] CG warm-start state (zeros here)


def solve(
    prob: BundleProblem,
    config: LMConfig = LMConfig(),
    lam_init=None,
    nu_init=None,
) -> Tuple[BundleProblem, LMStats]:
    """Run LM to convergence (or ``config.max_iters``).

    ``lam_init``/``nu_init`` override the damping state so a segmented solve
    continues exactly where a previous one stopped.  Only the dense
    component-major route is ported; the others raise
    ``NotImplementedError`` naming the ROADMAP item that brings them.
    """
    if not isinstance(prob, BundleProblem):
        raise NotImplementedError(
            f"{type(prob).__name__}: only BundleProblem is ported; the "
            "component-major CMProblem comes with the pcg route "
            "(ROADMAP.md queue 1, item 2)"
        )
    if config.solver == "pcg":
        raise NotImplementedError(
            "solver='pcg' is not ported yet (ROADMAP.md queue 1, items 2-6)"
        )
    if config.solver != "dense":
        raise ValueError(f"unknown solver {config.solver!r}")
    if config.layout == "std":
        raise NotImplementedError(
            "layout='std' is not ported yet (ROADMAP.md queue 1, item 8)"
        )
    if config.layout not in ("auto", "cm"):
        raise ValueError(f"unknown layout {config.layout!r}")
    return _solve_std(prob, config, lam_init, nu_init)


def _use_kernel(config: LMConfig, prob: BundleProblem) -> bool:
    """The rule of the JAX package's ``use_pallas``: "cuda" always takes the
    kernel's wrapper (f32 only), "auto" takes it iff the problem lives on a
    CUDA device in f32."""
    if config.jac_backend == "cuda":
        if prob.dtype != torch.float32:
            raise TypeError(
                f"jac_backend='cuda' needs an f32 problem, got {prob.dtype}"
            )
        return True
    if config.jac_backend == "torch":
        return False
    if config.jac_backend == "auto":
        return prob.device.type == "cuda" and prob.dtype == torch.float32
    raise ValueError(f"unknown jac_backend {config.jac_backend!r}")


def _linearize(p: BundleProblem, use_kernel: bool):
    """(rt [2,M], Jct [2CP,M], Jpt [6,M], wt [M]) at the current parameters."""
    if use_kernel:
        return proj.residuals_and_jacobians_cm(p)
    r, J_cam, J_pt, w = problem_mod.residuals_and_jacobians(p)
    M = r.shape[0]
    return r.T, J_cam.reshape(M, -1).T, J_pt.reshape(M, 6).T, w


def _solve_std(
    prob: BundleProblem,
    config: LMConfig,
    lam_init=None,
    nu_init=None,
) -> Tuple[BundleProblem, LMStats]:
    """The dense-cm LM loop."""
    dtype, dev = prob.dtype, prob.device
    n_it = config.max_iters
    use_kernel = _use_kernel(config, prob)
    tiny = torch.finfo(dtype).tiny

    def scalar(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    cost = problem_mod.cost(prob)
    lam = scalar(config.lam0 if lam_init is None else lam_init)
    nu = scalar(2.0 if nu_init is None else nu_init)
    costs = torch.full((n_it + 1,), float("nan"), dtype=dtype, device=dev)
    costs[0] = cost
    lams = torch.full((n_it,), float("nan"), dtype=dtype, device=dev)
    accepted = torch.zeros((n_it,), dtype=torch.bool, device=dev)
    grad_infs = torch.full((n_it,), float("nan"), dtype=dtype, device=dev)
    step_norms = torch.full((n_it,), float("nan"), dtype=dtype, device=dev)

    p = prob
    it = 0
    while it < n_it:
        rt, Jct, Jpt, wt = _linearize(p, use_kernel)
        eqs = schur_cm.build_normal_equations_cm(
            rt, Jct, Jpt, wt, p.obs_cam, p.pt_obs, p.pt_obs_mask, p.n_cameras,
        )
        grad_inf = schur_cm.grad_inf_cm(eqs)
        dc, dp = schur_cm.solve_step_cm(
            eqs, lam, p.obs_cam, p.obs_pt, p.pt_obs, p.pt_obs_mask,
        )
        cand = problem_mod.apply_update(p, dc, dp)
        new_cost = problem_mod.cost(cand)
        pred = schur_cm.predicted_reduction_cm(eqs, lam, dc, dp)
        actual = cost - new_cost
        rho = actual / torch.clamp(pred, min=tiny)
        ok = torch.isfinite(new_cost) & (actual > 0) & (pred > 0)

        # Nielsen damping schedule (same constants as the JAX loop).
        factor = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam_acc = torch.clamp(lam * factor, config.lam_min, config.lam_max)
        lam_rej = torch.clamp(lam * nu, config.lam_min, config.lam_max)
        lam_next = torch.where(ok, lam_acc, lam_rej)
        nu_next = torch.where(ok, 2.0, nu * 2.0)

        R = torch.where(ok, cand.R, p.R)
        k = config.renormalize_every
        if k > 0 and it % k == k - 1:
            R = torch.where(ok, so3.normalize(R), R)
        p_next = p.replace(
            R=R,
            t=torch.where(ok, cand.t, p.t),
            intr=torch.where(ok, cand.intr, p.intr),
            X=torch.where(ok, cand.X, p.X),
        )
        cost_next = torch.where(ok, new_cost, cost)

        step_norm = torch.sqrt(torch.sum(dc * dc) + torch.sum(dp * dp))
        converged = (
            (grad_inf < config.tol_grad)
            | (ok & (actual < config.tol_cost_rel * cost))
            | (step_norm < config.tol_step)
        )

        costs[it + 1] = cost_next
        lams[it] = lam
        accepted[it] = ok
        grad_infs[it] = grad_inf
        step_norms[it] = step_norm
        p, lam, nu, cost = p_next, lam_next, nu_next, cost_next
        it += 1
        # The one host read of the iteration: stop once converged.
        if bool(converged):
            break

    # Forward-fill the cost log past convergence so the tail is usable.
    it_idx = torch.arange(n_it + 1, device=dev)
    costs = torch.where(it_idx <= it, costs, cost)
    return p, LMStats(
        costs=costs,
        lams=lams,
        accepted=accepted,
        grad_inf=grad_infs,
        step_norms=step_norms,
        n_iters=torch.tensor(it, device=dev),
        lam_next=lam,
        nu_next=nu,
        cg_iters=torch.zeros((n_it,), dtype=torch.int32, device=dev),
        dc_next=torch.zeros((prob.n_cameras, prob.cam_dof), dtype=dtype, device=dev),
    )

