"""The pcg route as a whole: the port's ``solve(..., LMConfig(solver="pcg"))``
against the JAX package's on the same scene.

Tolerances: f64 cost logs within 1e-9 relative with identical accept
decisions and CG iteration counts (the two packages sum in other orders);
f32 with kernel operands within 1e-3 relative, as
``test_spmv.py::test_solve_cm_fully_grouped`` holds the JAX kernels to the
JAX plain route (f32 rounding along the iterations).
"""

import dataclasses

import numpy as np
import pytest
import torch

from pysfm_tpu.pipeline import synthetic as jsyn
from pysfm_tpu.solver import LMConfig as JLMConfig
from pysfm_tpu.solver import solve as jsolve
from pysfm_tpu.solver.lm import make_grouped_ops as jmake_grouped_ops
from pysfm_tpu_torch.pipeline import synthetic as tsyn
from pysfm_tpu_torch.problem import cm as tcm
from pysfm_tpu_torch.problem import problem as tprob
from pysfm_tpu_torch.solver import LMConfig, solve
from pysfm_tpu_torch.solver.kernels import spmv
from pysfm_tpu_torch.solver.lm import make_grouped_ops, solve_segmented

torch.set_num_threads(2)
NO_TOL = dict(tol_grad=0.0, tol_cost_rel=0.0, tol_step=0.0, solver="pcg")
# The bench.py headline settings.
HEADLINE = dict(cg_iters=25, cg_tol=1e-2, cg_forcing="ew", cg_q_tol=0.3)
BAL = dict(mean_track=4.0, max_track=8, noise_px=0.5, seed=3, with_truth=False,
           layout="cm")


def to_port_cm(p):
    arrays = {k: np.asarray(getattr(p, k)) for k in tcm.FIELDS}
    return tcm.from_numpy(arrays, p.camera_model, p.robust, device="cpu")


def _same_trajectory(sj, st):
    np.testing.assert_allclose(st.costs.numpy(), np.asarray(sj.costs), rtol=1e-9)
    np.testing.assert_array_equal(st.accepted.numpy(), np.asarray(sj.accepted))
    np.testing.assert_array_equal(st.cg_iters.numpy(), np.asarray(sj.cg_iters))
    assert int(st.n_iters) == int(sj.n_iters)
    np.testing.assert_allclose(st.lams.numpy(), np.asarray(sj.lams), rtol=1e-9)
    np.testing.assert_allclose(float(st.lam_next), float(sj.lam_next), rtol=1e-9)
    np.testing.assert_allclose(st.dc_next.numpy(), np.asarray(sj.dc_next),
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("options", [
    dict(max_iters=10, **HEADLINE),
    dict(max_iters=8, cg_iters=30, cg_tol=1e-6, cg_q_tol=0.1, cg_warm_start=False,
         reuse_linearization=False, cg_precond_terms=2, renormalize_every=2),
])
def test_solve_cm_matches_jax_f64(options):
    jp = jsyn.make_bal_scene(8, 500, robust="huber", robust_scale=2.0,
                             outlier_frac=0.05, dtype=np.float64, **BAL).problem
    cfg = dict(NO_TOL, **options)
    pj, sj = jsolve(jp, JLMConfig(**cfg))
    tp = to_port_cm(jp)
    launches = dict(spmv.LAUNCHES)
    # gops on an f64 problem is dropped (the kernels are f32), as in JAX.
    pt, st = solve(tp, LMConfig(**cfg), gops=make_grouped_ops(tp))
    assert spmv.LAUNCHES == launches
    assert isinstance(pt, tcm.CMProblem) and st.cg_iters.dtype == torch.int32
    _same_trajectory(sj, st)
    assert (st.cg_iters > 0).all() and st.costs[-1] < 0.5 * st.costs[0]
    np.testing.assert_allclose(pt.X3.numpy(), np.asarray(pj.X3), rtol=1e-7, atol=1e-9)


def test_bundle_problem_pcg_returns_bundle_problem():
    sc = jsyn.make_scene(12, 300, noise_px=0.5, visibility=0.5, robust="cauchy",
                         robust_scale=2.0, seed=4, dtype=np.float64)
    cfg = dict(NO_TOL, max_iters=6, **HEADLINE)
    pj, sj = jsolve(sc.problem, JLMConfig(**cfg))
    arrays = {k: np.asarray(getattr(sc.problem, k)) for k in tprob.FIELDS}
    pt, st = solve(tprob.from_numpy(arrays, "pose", "cauchy", device="cpu"), LMConfig(**cfg))
    assert isinstance(pt, tprob.BundleProblem)
    _same_trajectory(sj, st)
    for k in ("R", "t", "X"):
        np.testing.assert_allclose(getattr(pt, k).numpy(), np.asarray(getattr(pj, k)),
                                   rtol=1e-7, atol=1e-9, err_msg=k)


def test_solve_with_kernel_ops_f32_matches_jax_kernels():
    """f32 with kernel operands: the port (plain versions on the CPU) against
    the JAX package with its grouped Pallas kernels (interpret mode), the
    setting of ``test_solve_cm_fully_grouped``.  The JAX side runs the
    single-block matvecs (superstep 1), which compile in a fraction of the
    time of the two-phase ones; those are held to the port's products in
    ``test_torch_spmv.py``."""
    jp = jsyn.make_bal_scene(8, 500, dtype=np.float32, **BAL).problem
    cfg = dict(NO_TOL, max_iters=3, cg_iters=20, cg_tol=1e-6)
    _, sj = jsolve(jp, JLMConfig(**cfg), gops=jmake_grouped_ops(jp, superstep=1))
    tp = to_port_cm(jp)
    _, st = solve(tp, LMConfig(**cfg), gops=make_grouped_ops(tp))
    assert st.costs.dtype == torch.float32
    np.testing.assert_allclose(st.costs.numpy(), np.asarray(sj.costs), rtol=1e-3)


@pytest.mark.parametrize("kernel_ops", [False, True])
def test_reject_reuses_linearization_bitwise(kernel_ops):
    """A rejected step leaves the parameters unchanged, so the carried
    (eqs, b_rows) are reused instead of rebuilt; the trajectory must be
    bitwise the no-carry one (as ``tests/test_pcg.py``), on the plain route
    and through the kernel wrappers."""
    sc = tsyn.make_scene(
        12, 600, noise_px=1.0, outlier_frac=0.1, outlier_px=60.0,
        visibility=0.5, robust="cauchy", robust_scale=2.0,
        perturb_rot=0.15, perturb_trans=0.3, perturb_point=0.3, seed=3,
        dtype=np.float32, device="cpu",
    )
    cmp = tcm.from_problem(sc.problem)
    gops = make_grouped_ops(cmp) if kernel_ops else None
    cfg = LMConfig(max_iters=40, **dict(NO_TOL, **dict(HEADLINE, cg_iters=30)))
    _, st_reuse = solve(cmp, cfg, gops=gops)
    _, st_rebuild = solve(cmp, dataclasses.replace(cfg, reuse_linearization=False), gops=gops)
    assert (~st_reuse.accepted).any(), "scene produced no rejects; test exercises nothing"
    assert torch.equal(st_reuse.costs, st_rebuild.costs)
    assert torch.equal(st_reuse.cg_iters, st_rebuild.cg_iters)


def test_solve_segmented_equals_one_solve():
    """Damping state and CG warm start carried across segments: 4 + 4 + 2
    iterations are the same solve as 10 (fixed forcing: the EW sequence
    restarts at a segment's first iteration, in both packages)."""
    p = tsyn.make_bal_scene(8, 500, robust="huber", robust_scale=2.0,
                            dtype=np.float64, device="cpu", **BAL).problem
    cfg = LMConfig(max_iters=10, cg_iters=25, cg_tol=1e-3, cg_q_tol=0.1, **NO_TOL)
    _, full = solve(p, cfg)
    _, seg = solve_segmented(p, cfg, iters_per_dispatch=4)
    np.testing.assert_allclose(seg.costs.numpy(), full.costs.numpy(), rtol=1e-14)
    for f in ("accepted", "cg_iters"):
        assert torch.equal(getattr(seg, f), getattr(full, f)), f
    np.testing.assert_allclose(seg.lams.numpy(), full.lams.numpy(), rtol=1e-14)
    assert int(seg.n_iters) == 10


def test_bf16_rows_track_f32():
    """bf16 coupling rows (make_grouped_ops rows_dtype): storage bf16,
    arithmetic f32; the LM trajectory tracks the f32-rows one as in
    ``test_spmv.py::test_bf16_rows_solve_tracks_f32``."""
    sc = tsyn.make_scene(10, 400, noise_px=0.5, visibility=0.5, robust="huber",
                         robust_scale=2.0, seed=3, dtype=np.float32, device="cpu")
    cmp = tcm.from_problem(sc.problem)
    g32 = make_grouped_ops(cmp)
    g16 = make_grouped_ops(cmp, rows_dtype=torch.bfloat16)
    cfg = LMConfig(max_iters=12, **dict(NO_TOL, **dict(HEADLINE, cg_iters=20)))
    _, s32 = solve(cmp, cfg, gops=g32)
    _, s16 = solve(cmp, cfg, gops=g16)
    c32 = s32.costs.double().numpy()
    c16 = s16.costs.double().numpy()
    rel = np.abs(c16 - c32) / np.maximum(np.abs(c32), 1.0)
    assert rel.max() < 5e-3, rel.max()
    assert rel[-1] < 1e-4, rel[-1]


def test_launch_counts_follow_the_logs(monkeypatch):
    """``chip_smoke.py`` holds every kernel's launch count on the pcg route
    to what the LM and CG logs imply; on the CPU the same formula must equal
    the number of calls of each kernel wrapper."""
    import collections

    import chip_smoke

    calls = collections.Counter()
    for name in chip_smoke.SPMV_KERNELS:
        fn = getattr(spmv, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(spmv, name, counted)
    # The scene of the reuse test: it has rejected steps, where K_E is not
    # launched again.
    sc = tsyn.make_scene(
        12, 600, noise_px=1.0, outlier_frac=0.1, outlier_px=60.0,
        visibility=0.5, robust="cauchy", robust_scale=2.0,
        perturb_rot=0.15, perturb_trans=0.3, perturb_point=0.3, seed=3,
        dtype=np.float32, device="cpu",
    )
    cmp = tcm.from_problem(sc.problem)
    cfg = LMConfig(max_iters=40, **chip_smoke.NO_TOL, **chip_smoke.PCG_MAIN)
    gops = make_grouped_ops(cmp)
    _, st = solve(cmp, cfg, gops=gops)
    assert (~st.accepted).any()
    assert {k: calls[k] for k in chip_smoke.SPMV_KERNELS} == chip_smoke._expected_launches(st, cfg)
    assert calls["payload_b"] == 0  # K_D is on no solve path
    # A segmented solve: each segment builds and prices its start again.
    calls.clear()
    cfg = dataclasses.replace(cfg, max_iters=8)
    _, st = solve_segmented(cmp, cfg, iters_per_dispatch=3, gops=gops)
    assert ({k: calls[k] for k in chip_smoke.SPMV_KERNELS}
            == chip_smoke._expected_launches(st, cfg, seg=3))
