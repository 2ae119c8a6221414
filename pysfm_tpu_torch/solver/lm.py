"""Levenberg-Marquardt bundle adjustment: the dense routes and the pcg
route.

Port of ``pysfm_tpu.solver.lm``.  :func:`solve` dispatches as the JAX
package does: a :class:`~pysfm_tpu_torch.problem.cm.CMProblem`, or
``solver="pcg"``, runs the component-major pcg loop (:func:`cm_lm_loop`:
``solver/scale.py``, matrix-free PCG in ``solver/pcg.py``, and with
``gops`` the hand-written kernels of ``solver/kernels/spmv.py``); anything
else runs the dense loop (``_solve_std``, with the projection kernel of
``solver/kernels/proj.py``).  Accept/reject is
predicated (``torch.where`` on the candidate) and the damping follows
Nielsen's schedule, exactly as the JAX loops.  The dense loop runs
component-major (``layout="auto"`` / ``"cm"``: ``schur_cm``) or in the
standard layout (``layout="std"``: ``schur``, with the std wrapper of the
projection kernel).

The JAX package runs each loop inside one ``lax.while_loop`` under jit.
Here the dense loop's iteration is one function of a fixed set of tensors
(:func:`_iteration`); on a CUDA device without a group it is captured once
as a CUDA graph per shape and configuration (:class:`_DenseGraph`, cached
as ``jax.jit`` caches ``_solve_std``) and replayed once per iteration, and
the loop reads one scalar per iteration (``converged``).  The pcg loop is a
host loop over device tensors: it reads ``done`` and ``ok`` together in
one transfer per LM iteration, plus one ``go`` flag per CG iteration
(``pcg.pcg_solve``).

Both loops also run distributed (``group``, a
:class:`~pysfm_tpu_torch.dist.mesh.Mesh`; the JAX loops' ``axis_name``):
the problem (and ``gops``) is then one rank's point shard with the camera
state replicated.  Each linearization's camera partials Hcc and g_c are
summed over the ranks once (:func:`schur.sum_cameras`), and the cost, the
gradient norm, the predicted reduction and the step norm are reduced, so
every rank reads the same values at its host reads and takes the same
accept / reject / stop decisions.  ``dist.solve_sharded`` and
``dist.solve_sharded_cm`` call them so.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Tuple

import torch

from pysfm_tpu_torch.geometry import so3
from pysfm_tpu_torch.problem import cm
from pysfm_tpu_torch.problem import problem as problem_mod
from pysfm_tpu_torch.problem.problem import BundleProblem
from pysfm_tpu_torch.solver import pcg, scale, schur, schur_cm
from pysfm_tpu_torch.solver.kernels import proj, spmv
from pysfm_tpu_torch.utils.collectives import psum
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
    cg_iters: torch.Tensor    # [max_iters] int32: CG iterations per LM
                              # iteration (0 on the dense route)
    dc_next: torch.Tensor     # [C, CP] the last camera step: the CG warm
                              # start for a resumed solve (zeros on the
                              # dense route)

    def replace(self, **changes) -> "LMStats":
        """A copy with ``changes`` (the JAX struct's ``replace``)."""
        return dataclasses.replace(self, **changes)


def solve(
    prob,
    config: LMConfig = LMConfig(),
    lam_init=None,
    nu_init=None,
    gops=None,
    dc_init=None,
):
    """Run LM to convergence (or ``config.max_iters``).

    A :class:`~pysfm_tpu_torch.problem.cm.CMProblem` (or any problem with
    ``config.solver == "pcg"``) runs the component-major pcg loop
    (:func:`solve_cm`); a BundleProblem input always returns a
    BundleProblem.  ``lam_init``/``nu_init`` override the damping state and
    ``dc_init`` ([C, CP], ``stats.dc_next`` of a previous solve) the CG warm
    start, so a segmented solve continues exactly where a previous one
    stopped.  ``gops`` (:func:`make_grouped_ops`) routes the pcg loop
    through the kernels of ``solver/kernels/spmv.py``.  The dense solver
    runs component-major (``layout="auto"`` / ``"cm"``) or in the standard
    layout (``layout="std"``: ``solver/schur.py``).
    """
    if isinstance(prob, cm.CMProblem):
        return solve_cm(prob, config, lam_init, nu_init, gops, dc_init)
    if not isinstance(prob, BundleProblem):
        raise TypeError(
            f"solve() takes a BundleProblem or a CMProblem, got {type(prob).__name__}"
        )
    if config.solver == "pcg":
        cmp, stats = solve_cm(
            cm.from_problem(prob), config, lam_init, nu_init, gops, dc_init
        )
        return cm.merge_params(prob, cmp), stats
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


def _step_cm(p: BundleProblem, lam, use_kernel: bool, group=None):
    """(eqs, grad_inf, dc [C,CP], dp [P,3]) of the component-major route."""
    rt, Jct, Jpt, wt = _linearize(p, use_kernel)
    eqs = schur.sum_cameras(schur_cm.build_normal_equations_cm(
        rt, Jct, Jpt, wt, p.obs_cam, p.pt_obs, p.pt_obs_mask, p.n_cameras,
    ), group)
    dc, dp = schur_cm.solve_step_cm(
        eqs, lam, p.obs_cam, p.obs_pt, p.pt_obs, p.pt_obs_mask, group=group,
    )
    return eqs, schur_cm.grad_inf_cm(eqs, group), dc, dp


def _step_std(p: BundleProblem, lam, use_kernel: bool, group=None):
    """(eqs, grad_inf, dc [C,CP], dp [P,3]) of the standard-layout route: the
    std wrapper of the projection kernel (``[M, 2, CP]`` blocks), then
    ``schur`` with the visibility tables."""
    if use_kernel:
        r, J_cam, J_pt, w = proj.residuals_and_jacobians(p)
    else:
        r, J_cam, J_pt, w = problem_mod.residuals_and_jacobians(p)
    eqs = schur.sum_cameras(schur.build_normal_equations(
        r, J_cam, J_pt, w, p.obs_cam, p.obs_pt, p.n_cameras, p.n_points,
        pt_obs=p.pt_obs, pt_obs_mask=p.pt_obs_mask,
    ), group)
    dc, dp = schur.solve_step_dense(
        eqs, lam, p.obs_cam, p.obs_pt, pt_obs=p.pt_obs, pt_obs_mask=p.pt_obs_mask,
        group=group,
    )
    return eqs, schur_cm.grad_inf_cm(eqs, group), dc, dp


def _check_dense(config: LMConfig) -> None:
    if config.solver != "dense":
        raise ValueError(f"unknown solver {config.solver!r}")
    if config.layout not in ("auto", "cm", "std"):
        raise ValueError(f"unknown layout {config.layout!r}")


def _solve_std(
    prob: BundleProblem,
    config: LMConfig,
    lam_init=None,
    nu_init=None,
    group=None,
) -> Tuple[BundleProblem, LMStats]:
    """The dense LM loop, component-major (``layout`` "auto" / "cm") or in
    the standard layout ("std").  On a CUDA device without ``group`` each
    iteration is a replay of a cached CUDA graph (:func:`_solve_std_graphed`);
    a CPU problem, or a group, runs the same iteration eagerly.  With
    ``group`` ``prob`` is this rank's point shard (``dist.solve_sharded``)
    and the loop's sums run over the ranks."""
    _check_dense(config)
    # (A solve of 0 iterations has nothing to replay.)
    if prob.device.type == "cuda" and group is None and config.max_iters > 0:
        return _solve_std_graphed(prob, config, lam_init, nu_init)
    return _solve_std_eager(prob, config, lam_init, nu_init, group)


def _route(config: LMConfig, prob: BundleProblem):
    """(step, predicted reduction, use_kernel) of the dense loop."""
    use_kernel = _use_kernel(config, prob)
    if config.layout == "std":
        return _step_std, schur.predicted_reduction, use_kernel
    return _step_cm, schur_cm.predicted_reduction_cm, use_kernel


def _init_state(prob: BundleProblem, config: LMConfig, lam_init, nu_init, group):
    """(cost, lam, nu) at the start of a solve.  A number becomes a tensor
    by a fill on the device, not a copy from the host (which would wait for
    the device)."""
    def scalar(v):
        if isinstance(v, torch.Tensor):
            return v.to(dtype=prob.dtype, device=prob.device)
        return torch.full((), float(v), dtype=prob.dtype, device=prob.device)

    cost = psum(problem_mod.cost(prob), group)
    lam = scalar(config.lam0 if lam_init is None else lam_init)
    nu = scalar(2.0 if nu_init is None else nu_init)
    return cost, lam, nu


def _new_logs(n_it: int, dtype, dev):
    """(costs, lams, accepted, grad_infs, step_norms), as before iteration 0
    (``costs[0]`` still to be set)."""
    def nans(n):
        return torch.full((n,), float("nan"), dtype=dtype, device=dev)

    return (nans(n_it + 1), nans(n_it), torch.zeros((n_it,), dtype=torch.bool, device=dev),
            nans(n_it), nans(n_it))


def _iteration(p: BundleProblem, lam, nu, cost, it, logs, config: LMConfig, route,
               group=None):
    """One LM iteration of the dense loop, a function of tensors only.

    Reads the parameters of ``p``, the damping state ``lam`` / ``nu``, the
    current ``cost`` and the iteration counter ``it`` (an int64 scalar on
    the device); writes entry ``it`` of the logs in place (``costs`` at
    ``it + 1``); returns ``(p_next, lam_next, nu_next, cost_next, it + 1,
    converged)``.  Nothing in it depends on a host value that changes from
    one iteration to the next, so a CUDA graph of it replays any iteration.
    """
    step, predicted, use_kernel = route
    tiny = torch.finfo(p.dtype).tiny
    eqs, grad_inf, dc, dp = step(p, lam, use_kernel, group)
    cand = problem_mod.apply_update(p, dc, dp)
    new_cost = psum(problem_mod.cost(cand), group)
    pred = predicted(eqs, lam, dc, dp, group=group)
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
    if k > 0:
        # The JAX loop's predicate, on the device counter.
        renorm = ok & (it % k == k - 1)
        R = torch.where(renorm, so3.normalize_near(R), R)
    p_next = p.replace(
        R=R,
        t=torch.where(ok, cand.t, p.t),
        intr=torch.where(ok, cand.intr, p.intr),
        X=torch.where(ok, cand.X, p.X),
    )
    cost_next = torch.where(ok, new_cost, cost)

    step_norm = torch.sqrt(torch.sum(dc * dc) + psum(torch.sum(dp * dp), group))
    converged = (
        (grad_inf < config.tol_grad)
        | (ok & (actual < config.tol_cost_rel * cost))
        | (step_norm < config.tol_step)
    )

    costs, lams, accepted, grad_infs, step_norms = logs
    i = it.reshape(1)
    costs.index_copy_(0, i + 1, cost_next.reshape(1))
    for log, v in ((lams, lam), (accepted, ok), (grad_infs, grad_inf), (step_norms, step_norm)):
        log.index_copy_(0, i, v.reshape(1))
    return p_next, lam_next, nu_next, cost_next, it + 1, converged


def _stats(prob: BundleProblem, logs, cost, lam, nu, it: int) -> LMStats:
    """The stats after ``it`` iterations; the cost log is forward-filled past
    the last iteration so the tail is usable."""
    costs, lams, accepted, grad_infs, step_norms = logs
    dtype, dev, n_it = costs.dtype, costs.device, lams.shape[0]
    it_idx = torch.arange(n_it + 1, device=dev)
    return LMStats(
        costs=torch.where(it_idx <= it, costs, cost),
        lams=lams,
        accepted=accepted,
        grad_inf=grad_infs,
        step_norms=step_norms,
        n_iters=torch.full((), it, dtype=torch.int64, device=dev),
        lam_next=lam,
        nu_next=nu,
        cg_iters=torch.zeros((n_it,), dtype=torch.int32, device=dev),
        dc_next=torch.zeros((prob.n_cameras, prob.cam_dof), dtype=dtype, device=dev),
    )


def _solve_std_eager(
    prob: BundleProblem,
    config: LMConfig,
    lam_init=None,
    nu_init=None,
    group=None,
) -> Tuple[BundleProblem, LMStats]:
    """The dense loop with each iteration's operations launched from Python
    (CPU problems and ``group``; on the card, the graphed loop's
    reference in ``chip_smoke.py``)."""
    route = _route(config, prob)
    cost, lam, nu = _init_state(prob, config, lam_init, nu_init, group)
    logs = _new_logs(config.max_iters, prob.dtype, prob.device)
    logs[0][0] = cost
    p, it_t, it = prob, torch.zeros((), dtype=torch.int64, device=prob.device), 0
    while it < config.max_iters:
        p, lam, nu, cost, it_t, converged = _iteration(
            p, lam, nu, cost, it_t, logs, config, route, group)
        it += 1
        # The one host read of the iteration: stop once converged (under a
        # group from reduced values, the same on every rank).
        if bool(converged):
            break
    return p, _stats(prob, logs, cost, lam, nu, it)


# Captured iterations of the dense loop, least recently used first: the
# counterpart of jax.jit's cache of _solve_std (enough for the incremental
# path's BA buckets).  Each entry holds its graph's memory pool and its
# static tensors.
GRAPH_CACHE_SIZE = 16
_GRAPHS: "collections.OrderedDict[tuple, _DenseGraph]" = collections.OrderedDict()


def _graph_key(prob: BundleProblem, config: LMConfig) -> tuple:
    """Everything a capture bakes into the graph: every tensor's shape and
    type, the device, the camera model and robust kernel, the configuration
    (its bounds and tolerances are launch arguments), the layout and
    whether the projection kernel runs.  Two problems with one key differ
    only in their values."""
    return (
        tuple((tuple(getattr(prob, k).shape), getattr(prob, k).dtype)
              for k in problem_mod.FIELDS),
        prob.device, prob.camera_model, prob.robust, config,
        "std" if config.layout == "std" else "cm", _use_kernel(config, prob),
    )


def _launch_counts():
    """(proj's launch count, a copy of spmv's counts)."""
    return proj.LAUNCHES, dict(spmv.LAUNCHES)


class _DenseGraph:
    """One iteration of the dense loop captured as a CUDA graph, with the
    static tensors it reads and writes: the problem, the damping state, the
    cost, the device iteration counter, the logs and ``converged``."""

    def __init__(self, prob: BundleProblem, config: LMConfig):
        self.config, self.route = config, _route(config, prob)
        self.p = prob.replace(**{k: getattr(prob, k).clone(
            memory_format=torch.contiguous_format) for k in problem_mod.FIELDS})
        dtype, dev = prob.dtype, prob.device
        self.lam, self.nu, self.cost = (torch.zeros((), dtype=dtype, device=dev)
                                        for _ in range(3))
        self.it = torch.zeros((), dtype=torch.int64, device=dev)
        self.converged = torch.zeros((), dtype=torch.bool, device=dev)
        self.logs = _new_logs(config.max_iters, dtype, dev)
        self.graph = None
        # Kernel launches one replay makes (proj's count, spmv's counts), and
        # the host time of the capture and the graph's instantiation.
        self.launches = (0, {})
        self.capture_ms = None

    def load(self, prob: BundleProblem, cost, lam, nu) -> None:
        """Copy a problem and its initial state into the static tensors."""
        for k in problem_mod.FIELDS:
            getattr(self.p, k).copy_(getattr(prob, k))
        for dst, src in ((self.cost, cost), (self.lam, lam), (self.nu, nu)):
            dst.copy_(src)
        self.it.zero_()
        self.converged.zero_()
        costs, lams, accepted, grad_infs, step_norms = self.logs
        for log in (costs, lams, grad_infs, step_norms):
            log.fill_(float("nan"))
        accepted.zero_()
        costs[0] = cost

    def _advance(self) -> None:
        """One iteration from the static state into the static state."""
        p, lam, nu, cost, it, converged = _iteration(
            self.p, self.lam, self.nu, self.cost, self.it, self.logs, self.config, self.route)
        for dst, src in ((self.p.R, p.R), (self.p.t, p.t), (self.p.intr, p.intr),
                         (self.p.X, p.X), (self.lam, lam), (self.nu, nu), (self.cost, cost),
                         (self.it, it), (self.converged, converged)):
            dst.copy_(src)

    def first_and_capture(self) -> None:
        """Run the loaded solve's first iteration eagerly on a side stream
        (the warm-up: it loads the kernel library and sets up cuBLAS's and
        cuSOLVER's handles and workspaces), then capture the iteration on
        that stream.  ``capture_begin``/``capture_end`` directly, not
        ``torch.cuda.graph``, whose ``empty_cache`` would hand every cached
        block of the process back to the driver at each capture.  A capture
        launches nothing, so the launch counts it added are taken back, and
        each replay adds them."""
        dev = self.p.device
        main, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
        side.wait_stream(main)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            self._advance()
            proj_before, spmv_before = _launch_counts()
            t0 = time.perf_counter()
            graph.capture_begin()
            try:
                self._advance()
            finally:
                graph.capture_end()
                proj_after, spmv_after = _launch_counts()
                proj.LAUNCHES = proj_before
                spmv.LAUNCHES.update(spmv_before)
        main.wait_stream(side)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.launches = (proj_after - proj_before,
                         {k: v - spmv_before[k] for k, v in spmv_after.items()})
        self.graph = graph

    def replay(self) -> None:
        self.graph.replay()
        n_proj, n_spmv = self.launches
        proj.LAUNCHES += n_proj
        for k, v in n_spmv.items():
            spmv.LAUNCHES[k] += v


def _solve_std_graphed(
    prob: BundleProblem,
    config: LMConfig,
    lam_init=None,
    nu_init=None,
) -> Tuple[BundleProblem, LMStats]:
    """The dense loop on a CUDA device: the iteration of :func:`_iteration`
    replayed from a cached CUDA graph, one host read per iteration.

    The first solve of a key (:func:`_graph_key`) runs its first iteration
    eagerly and captures the graph; every later one copies its problem and
    initial state into the graph's static tensors and replays from
    iteration 0.  The result is cloned out of the static tensors, so a
    later solve leaves it alone.  A failed capture or replay raises."""
    key = _graph_key(prob, config)
    cost, lam, nu = _init_state(prob, config, lam_init, nu_init, None)
    with torch.cuda.device(prob.device):
        g = _GRAPHS.pop(key, None)
        it = 0 if g is not None else 1
        if g is None:
            g = _DenseGraph(prob, config)
        g.load(prob, cost, lam, nu)
        if it:
            g.first_and_capture()
        _GRAPHS[key] = g   # the most recently used
        while len(_GRAPHS) > GRAPH_CACHE_SIZE:
            _GRAPHS.popitem(last=False)
        while it < config.max_iters:
            # The one host read of the iteration: stop once converged.
            if it > 0 and bool(g.converged):
                break
            g.replay()
            it += 1
    out = prob.replace(R=g.p.R.clone(), t=g.p.t.clone(), intr=g.p.intr.clone(),
                       X=g.p.X.clone())
    logs = tuple(log.clone() for log in g.logs)
    return out, _stats(prob, logs, g.cost.clone(), g.lam.clone(), g.nu.clone(), it)


def make_grouped_ops(cmp: cm.CMProblem, rows_dtype=None) -> spmv.GroupedOps:
    """The kernel operands of a CMProblem (once per problem): CSR offsets of
    each point's observations, the observations sorted by camera, the plans
    of the kernels, and the measurements in both orders, on the problem's
    device.  Pass the result to :func:`solve` / :func:`solve_cm` as ``gops``.

    Memory: besides the problem's own arrays, the static layout holds
    ``cam_perm``, ``cam_pt`` and the camera-sorted u, v, w, 20 B an
    observation (100 MB at Venice, M ~ 5M; u, v, w 60 MB).  ``rows_dtype`` is
    the storage type of the per-iteration coupling rows (default: the
    problem's dtype).  Each linearization stores them twice, ``b_rows``
    point-sorted and ``b_cam`` camera-sorted, ``2 * 3*CP*M`` elements: 720
    MB at Venice (CP = 6) in f32.  The loop drops a linearization before it
    builds the next, so one pair is live at a time.  K_H's scratch (Hinv
    point-major, 32 B a point) lives for one call.
    ``torch.bfloat16`` halves the rows' memory and the bytes every CG
    product streams; all kernel arithmetic stays f32, so the CG operator is
    a fixed bf16-rounded S whose ~4e-3 relative rounding sits inside a
    ``cg_tol`` of 1e-2."""
    return spmv.grouped_ops(
        cmp.obs_cam, cmp.obs_pt, cmp.n_cameras, cmp.n_points,
        cmp.u, cmp.v, cmp.obs_w,
        cmp.dtype if rows_dtype is None else rows_dtype,
    )


def solve_cm(
    cmp: cm.CMProblem,
    config: LMConfig = LMConfig(),
    lam_init=None,
    nu_init=None,
    gops=None,
    dc_init=None,
) -> Tuple[cm.CMProblem, LMStats]:
    """Component-major BAL-scale LM loop (the ``pcg`` solver route).
    Returns ``(CMProblem, LMStats)``."""
    return cm_lm_loop(cmp, config, lam_init, nu_init, gops, dc_init=dc_init)


def cm_lm_loop(
    cmp: cm.CMProblem,
    config: LMConfig = LMConfig(),
    lam_init=None,
    nu_init=None,
    gops=None,
    group=None,
    cam_shards: int = 0,
    dc_init=None,
) -> Tuple[cm.CMProblem, LMStats]:
    """The component-major LM loop.

    Same control flow as the dense loop (Nielsen damping, predicated
    accept/reject), with the CG step of ``solver/pcg.py``, the
    Eisenstat-Walker forcing sequence (``config.cg_forcing="ew"``), the CG
    warm start, and ``config.reuse_linearization``: after a rejected step
    the parameters are unchanged, so the carried ``(eqs, b_rows, b_cam)``
    are reused instead of rebuilt, and a solve builds ``1 +`` (steps accepted
    before its last iteration) times.

    With ``gops`` the cost, the normal equations and every product with Hcp
    run through ``solver/kernels/spmv.py``.  As in the JAX package, ``gops``
    is dropped for a non-f32 problem: the kernels compute in f32, and an
    f64 problem keeps its precision on the plain route (``solver/scale.py``).

    With ``group`` this is the distributed loop of
    :func:`pysfm_tpu_torch.dist.solve_sharded_cm`: ``cmp`` and ``gops`` are
    this rank's shard; each linearization's Hcc and g_c are summed over the
    ranks once, the cost, the gradient norm, the predicted reduction and
    the step norm are reduced, and the CG step sums its point-derived
    camera partials (``pcg``).  ``cam_shards`` > 0 (with ``group``) also
    partitions the camera axis of the reduced solve
    (:class:`~pysfm_tpu_torch.solver.pcg.CamShard`); the camera parameters
    stay replicated.  With ``group=None`` nothing is reduced and no
    collective runs.
    """
    dtype, dev = cmp.dtype, cmp.device
    if gops is not None and dtype != torch.float32:
        gops = None
    n_it = config.max_iters
    tiny = torch.finfo(dtype).tiny

    def scalar(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    def cost_local(q):
        if gops is not None:
            return spmv.cost(
                gops, cm.cam_table(q), q.X3, q.robust_scale,
                model=q.camera_model, robust=q.robust,
            ).to(dtype)
        return scale.cost_scale_cm(q, config.obs_chunk)

    def cost_fn(q):
        return psum(cost_local(q), group)

    def build_lin(q):
        """(eqs, b_rows, b_cam) linearized at q; the rows are None off the
        kernels."""
        if gops is not None:
            eqs, b_rows, b_cam = spmv.build_eqs(
                gops, cm.cam_table(q), q.X3, q.robust_scale,
                cp=q.cam_dof, model=q.camera_model, robust=q.robust,
                n_cameras=q.n_cameras, n_points=q.n_points,
            )
        else:
            eqs = scale.build_normal_equations_scale_cm(q, config.obs_chunk)
            b_rows = b_cam = None
        return schur.sum_cameras(eqs, group), b_rows, b_cam

    reuse_lin = config.reuse_linearization
    cost = cost_fn(cmp)
    lam = scalar(config.lam0 if lam_init is None else lam_init)
    nu = scalar(2.0 if nu_init is None else nu_init)
    costs = torch.full((n_it + 1,), float("nan"), dtype=dtype, device=dev)
    costs[0] = cost
    lams = torch.full((n_it,), float("nan"), dtype=dtype, device=dev)
    accepted = torch.zeros((n_it,), dtype=torch.bool, device=dev)
    grad_infs = torch.full((n_it,), float("nan"), dtype=dtype, device=dev)
    step_norms = torch.full((n_it,), float("nan"), dtype=dtype, device=dev)
    cg_iters = torch.zeros((n_it,), dtype=torch.int32, device=dev)
    dc_prev = (
        torch.zeros((cmp.n_cameras, cmp.cam_dof), dtype=dtype, device=dev)
        if dc_init is None else torch.as_tensor(dc_init, dtype=dtype, device=dev)
    )
    eta = scalar(config.cg_tol_max)
    grad_prev = scalar(0.0)
    prev_ok = True
    # With the carry, the first linearization is hoisted out of the loop and
    # the loop rebuilds only after accepted steps.
    lin = build_lin(cmp) if reuse_lin else None

    p = cmp
    it = 0
    while it < n_it:
        if not reuse_lin or (prev_ok and it > 0):
            # Nothing reads the old linearization now: free its rows before
            # the new ones are stored, so that one pair of copies is live.
            lin = eqs = b_rows = b_cam = gops_it = None
            lin = build_lin(p)
        eqs, b_rows, b_cam = lin
        gops_it = None if gops is None else gops.replace(b_rows=b_rows, b_cam=b_cam)
        grad_inf = schur_cm.grad_inf_cm(eqs, group)
        if config.cg_forcing == "ew":
            # Eisenstat-Walker choice 2 (gamma = 0.9, alpha = 2) on the
            # gradient-norm ratio, with the safeguard against over-
            # tightening and a 4x tighten after a rejected step.
            gamma = 0.9
            ratio = grad_inf / torch.clamp(grad_prev, min=tiny)
            eta_ew = gamma * ratio * ratio
            safe = gamma * eta * eta
            eta_ew = torch.where(safe > 0.1, torch.maximum(eta_ew, safe), eta_ew)
            if it == 0:
                eta_i = scalar(config.cg_tol_max)
            elif prev_ok:
                eta_i = torch.clamp(eta_ew, config.cg_tol, config.cg_tol_max)
            else:
                eta_i = torch.clamp(0.25 * eta, min=config.cg_tol)
            tol_i = eta_i
        else:
            eta_i = scalar(config.cg_tol)
            tol_i = config.cg_tol
        dc, dp3, n_cg = pcg.solve_step_pcg_cm3(
            eqs, lam, p.obs_cam, p.obs_pt,
            tol=tol_i, max_iters=config.cg_iters,
            pt_obsT=p.pt_obsT, pt_obs_maskT=p.pt_obs_maskT,
            cam_obs=p.cam_obs, cam_obs_mask=p.cam_obs_mask,
            dc_warm=dc_prev if config.cg_warm_start else None,
            gops=gops_it,
            q_tol=config.cg_q_tol,
            precond_terms=config.cg_precond_terms,
            group=group,
            cam_shards=cam_shards,
        )
        cand = cm.apply_update_cm(p, dc, dp3)
        new_cost = cost_fn(cand)
        pred = scale.predicted_reduction_scale_cm(eqs, lam, dc, dp3, group=group)
        actual = cost - new_cost
        rho = actual / torch.clamp(pred, min=tiny)
        ok = torch.isfinite(new_cost) & (actual > 0) & (pred > 0)

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
            X3=torch.where(ok, cand.X3, p.X3),
        )
        cost_next = torch.where(ok, new_cost, cost)

        step_norm = torch.sqrt(torch.sum(dc * dc) + psum(torch.sum(dp3 * dp3), group))
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
        cg_iters[it] = n_cg
        p, lam, nu, cost = p_next, lam_next, nu_next, cost_next
        dc_prev, eta, grad_prev = dc, eta_i, grad_inf
        it += 1
        # The one host read of the LM iteration: stop once converged, and
        # whether to rebuild the linearization next time.  Under a group
        # both come from reduced values, the same on every rank.
        done, prev_ok = torch.stack([converged, ok]).tolist()
        if done:
            break

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
        cg_iters=cg_iters,
        dc_next=dc_prev,
    )


def solve_segmented(
    prob,
    config: LMConfig = LMConfig(),
    iters_per_dispatch: int = 6,
    gops=None,
) -> Tuple[object, LMStats]:
    """:func:`solve` run as segments of ``iters_per_dispatch`` iterations,
    carrying the damping state and the CG warm start across segments
    exactly, so the result is that of one solve of ``config.max_iters``.
    The stats are concatenated over the iterations actually run."""
    total = config.max_iters
    k = max(1, iters_per_dispatch)
    dtype, dev = prob.dtype, prob.device
    lam = torch.as_tensor(config.lam0, dtype=dtype, device=dev)
    nu = torch.as_tensor(2.0, dtype=dtype, device=dev)
    dc = torch.zeros((prob.n_cameras, prob.cam_dof), dtype=dtype, device=dev)
    p = prob
    parts = {f: [] for f in ("costs", "lams", "accepted", "grad_inf",
                             "step_norms", "cg_iters")}
    n_done = 0
    while n_done < total:
        kk = min(k, total - n_done)
        p, st = solve(
            p, dataclasses.replace(config, max_iters=kk),
            lam_init=lam, nu_init=nu, gops=gops, dc_init=dc,
        )
        n_it = int(st.n_iters)
        if not parts["costs"]:
            parts["costs"].append(st.costs[:1])
        parts["costs"].append(st.costs[1:n_it + 1])
        for f in ("lams", "accepted", "grad_inf", "step_norms", "cg_iters"):
            parts[f].append(getattr(st, f)[:n_it])
        lam, nu, dc = st.lam_next, st.nu_next, st.dc_next
        n_done += n_it
        if n_it < kk:  # converged inside the segment
            break
    return p, LMStats(
        **{f: torch.cat(v) for f, v in parts.items()},
        n_iters=torch.tensor(n_done, device=dev),
        lam_next=lam,
        nu_next=nu,
        dc_next=dc,
    )
