"""The slice as a whole: the port's ``solve()`` (dense component-major LM)
against the JAX package's on the same scene, and the port's ``make_scene``
against the JAX package's.

Tolerances: f64 cost logs within 1e-9 relative with identical accept
decisions (the two packages sum in other orders, and the differences grow
over the iterations from 1e-15); f32 final cost within 1e-3 relative (f32
rounding along ten iterations, which can flip a near-tie accept).
"""

import dataclasses

import numpy as np
import pytest
import torch

from pysfm_tpu.pipeline import synthetic as jsyn
from pysfm_tpu.solver import LMConfig as JLMConfig
from pysfm_tpu.solver import solve as jsolve
from pysfm_tpu_torch.pipeline import synthetic as tsyn
from pysfm_tpu_torch.problem import problem as tprob
from pysfm_tpu_torch.solver import LMConfig, solve

torch.set_num_threads(2)
SCENE = dict(noise_px=0.5, outlier_frac=0.05, outlier_px=40.0,
             robust="huber", robust_scale=2.0, seed=11)
NO_TOL = dict(max_iters=10, tol_grad=0.0, tol_cost_rel=0.0, tol_step=0.0)


def to_port(p):
    arrays = {k: np.asarray(getattr(p, k)) for k in tprob.FIELDS}
    return tprob.from_numpy(arrays, p.camera_model, p.robust)


def _solve_both(p, **cfg):
    pj, sj = jsolve(p, JLMConfig(**cfg))
    pt, st = solve(to_port(p), LMConfig(**cfg))
    return (pj, sj), (pt, st)


@pytest.mark.parametrize("renormalize_every", [0, 2])
def test_solve_matches_jax_f64(renormalize_every):
    p = jsyn.make_scene(6, 300, dtype=np.float64, **SCENE).problem
    (pj, sj), (pt, st) = _solve_both(
        p, renormalize_every=renormalize_every, **NO_TOL)
    np.testing.assert_allclose(st.costs.numpy(), np.asarray(sj.costs), rtol=1e-9)
    np.testing.assert_array_equal(st.accepted.numpy(), np.asarray(sj.accepted))
    assert int(st.n_iters) == int(sj.n_iters) == 10
    np.testing.assert_allclose(st.lams.numpy(), np.asarray(sj.lams), rtol=1e-9)
    np.testing.assert_allclose(float(st.lam_next), float(sj.lam_next), rtol=1e-9)
    np.testing.assert_allclose(pt.X.numpy(), np.asarray(pj.X), rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(pt.R.numpy(), np.asarray(pj.R), rtol=1e-7, atol=1e-9)
    assert st.costs[-1] < st.costs[0]


def test_solve_matches_jax_f32():
    p = jsyn.make_scene(6, 300, dtype=np.float32, **SCENE).problem
    (_, sj), (pt, st) = _solve_both(p, **NO_TOL)
    assert pt.X.dtype == torch.float32 and st.costs.dtype == torch.float32
    c_j, c_t = float(sj.costs[-1]), float(st.costs[-1])
    assert abs(c_t - c_j) <= 1e-3 * abs(c_j)


def test_early_convergence_matches_jax():
    """Default tolerances on an exact two-view scene: LM stops early and the
    cost log is forward-filled past the last iteration.  The cost falls to
    roundoff (~1e-20), where the two packages' summation orders differ in
    the leading digits, hence atol 1e-18 and rtol 1e-6 on the log."""
    p = jsyn.make_scene(2, 100, noise_px=0.0, seed=1, dtype=np.float64).problem
    (_, sj), (_, st) = _solve_both(p, max_iters=50)
    assert int(st.n_iters) == int(sj.n_iters) < 50
    np.testing.assert_allclose(st.costs.numpy(), np.asarray(sj.costs),
                               rtol=1e-6, atol=1e-18)
    n = int(st.n_iters)
    assert (st.costs[n:] == st.costs[n]).all()


def test_make_scene_matches_jax():
    kw = dict(camera_model="bal", visibility=0.6, dtype=np.float64, **SCENE)
    a = jsyn.make_scene(5, 80, **kw)
    b = tsyn.make_scene(5, 80, **kw)
    for pj, pt in ((a.truth, b.truth), (a.problem, b.problem)):
        for k in tprob.FIELDS:
            x, y = np.asarray(getattr(pj, k)), getattr(pt, k).numpy()
            assert x.dtype == y.dtype, k
            np.testing.assert_allclose(y, x, rtol=1e-12, atol=1e-9, err_msg=k)


def test_segmented_solve_continues_exactly():
    """lam_next / nu_next carry the damping state: 4 + 6 iterations are the
    same solve as 10."""
    p = tsyn.make_scene(6, 300, dtype=np.float64, **SCENE).problem
    cfg = LMConfig(**NO_TOL)
    _, full = solve(p, cfg)
    p4, s4 = solve(p, dataclasses.replace(cfg, max_iters=4))
    _, s6 = solve(p4, dataclasses.replace(cfg, max_iters=6),
                  lam_init=s4.lam_next, nu_init=s4.nu_next)
    np.testing.assert_allclose(
        torch.cat([s4.costs, s6.costs[1:]]).numpy(), full.costs.numpy(), rtol=1e-12)


def test_kernel_route_on_cpu_is_the_plain_route():
    """jac_backend="cuda" goes through the kernel's wrapper, which runs the
    plain version for CPU tensors: same result as "torch"."""
    p = tsyn.make_scene(4, 60, dtype=np.float32, **SCENE).problem
    _, a = solve(p, LMConfig(jac_backend="cuda", **NO_TOL))
    _, b = solve(p, LMConfig(jac_backend="torch", **NO_TOL))
    np.testing.assert_allclose(a.costs.numpy(), b.costs.numpy(), rtol=1e-6)


def test_unported_routes_raise():
    p = tsyn.make_scene(3, 20, seed=1).problem
    with pytest.raises(TypeError):
        solve(p, LMConfig(jac_backend="cuda"))  # the kernel is f32 only
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solve(p, LMConfig(solver="pcg"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solve(p, LMConfig(layout="std"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solve(object(), LMConfig())
    with pytest.raises(ValueError):
        solve(p, LMConfig(jac_backend="pallas"))


def test_timeit_runs_on_cpu():
    from pysfm_tpu_torch.utils import timing

    p = tsyn.make_scene(3, 20, seed=1).problem
    secs = timing.timeit(solve, p, LMConfig(max_iters=2), n=2)
    timing.sync()
    assert secs > 0.0
