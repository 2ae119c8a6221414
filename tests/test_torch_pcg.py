"""Matrix-free PCG (``solver/pcg.py``) against the JAX package's, in f64 on
the same normal equations: rtol/atol 1e-10 for the operators and 1e-8 for
CG iterates (whose rounding grows with the iterations), and the same
number of CG iterations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysfm_tpu.pipeline import synthetic as jsyn
from pysfm_tpu.problem import cm as jcm
from pysfm_tpu.problem import problem as jprob
from pysfm_tpu.solver import pcg as jpcg
from pysfm_tpu.solver import scale as jscale
from pysfm_tpu.solver import schur as jschur
from pysfm_tpu_torch.problem import cm as tcm
from pysfm_tpu_torch.problem import problem as tprob
from pysfm_tpu_torch.solver import pcg as tpcg
from pysfm_tpu_torch.solver import scale as tscale
from pysfm_tpu_torch.solver.lm import make_grouped_ops

torch.set_num_threads(2)
TOL = dict(rtol=1e-10, atol=1e-10)
LAM = 1e-3


def _close(a, b, **tol):
    np.testing.assert_allclose(b.numpy(), np.asarray(a), **(tol or TOL))


@pytest.fixture(scope="module")
def scene():
    return jsyn.make_scene(12, 300, noise_px=0.5, outlier_frac=0.05,
                           outlier_px=30.0, visibility=0.5, robust="huber",
                           robust_scale=2.0, seed=5, dtype=np.float64)


@pytest.fixture(scope="module")
def both(scene):
    """(JAX CMProblem, its ScaleEqs), (port CMProblem, its ScaleEqs)."""
    jp = jcm.from_problem(scene.problem)
    arrays = {k: np.asarray(getattr(scene.problem, k)) for k in tprob.FIELDS}
    tp = tcm.from_problem(tprob.from_numpy(arrays, "pose", "huber", device="cpu"))
    return ((jp, jscale.build_normal_equations_scale_cm(jp)),
            (tp, tscale.build_normal_equations_scale_cm(tp)))


def _tables(p):
    return dict(pt_obsT=p.pt_obsT, pt_obs_maskT=p.pt_obs_maskT,
                cam_obs=p.cam_obs, cam_obs_mask=p.cam_obs_mask)


def _port_systems(tp, te, keep_D=False):
    """The port's three operator routes on the same equations."""
    lam = torch.tensor(LAM, dtype=torch.float64)
    ops = make_grouped_ops(tp).replace(b_rows=te.B_cm)
    return {
        "tables": tpcg.build_pcg_system(te, lam, tp.obs_cam, tp.obs_pt,
                                        keep_D=keep_D, **_tables(tp)),
        "segment": tpcg.build_pcg_system(te, lam, tp.obs_cam, tp.obs_pt, keep_D=keep_D),
        "kernels": tpcg.build_pcg_system(te._replace(B_cm=None), lam, tp.obs_cam,
                                         tp.obs_pt, gops=ops, keep_D=keep_D),
    }


def test_build_pcg_system_all_routes_match(both):
    (jp, je), (tp, te) = both
    js = jpcg.build_pcg_system(je, jnp.float64(LAM), jp.obs_cam, jp.obs_pt, **_tables(jp))
    x = np.random.default_rng(0).normal(size=(tp.cam_dof, tp.n_cameras))
    Sx = jpcg.schur_matvec(js, jnp.asarray(x))
    for route, ts in _port_systems(tp, te).items():
        for name in ("Hcc_aug", "hinv6", "rhs", "g_p", "M_inv"):
            np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                       **TOL, err_msg=f"{route}: {name}")
        _close(Sx, tpcg.schur_matvec(ts, torch.from_numpy(x)))
        _close(jpcg.back_substitute(js, jnp.asarray(x)),
               tpcg.back_substitute(ts, torch.from_numpy(x)))
    assert _port_systems(tp, te)["kernels"].Bp is None


def test_schur_matvec_against_materialized_s(scene, both):
    """S x through the implicit chain == S x through the dense S of the JAX
    package's std-layout Schur reduction."""
    p = scene.problem
    r, J_cam, J_pt, w = jprob.residuals_and_jacobians(p)
    eqs = jschur.build_normal_equations(r, J_cam, J_pt, w, p.obs_cam, p.obs_pt,
                                        p.n_cameras, p.n_points)
    S = np.asarray(jschur.reduce_dense(eqs, jnp.float64(LAM), p.obs_cam, p.obs_pt).S)
    (_, _), (tp, te) = both
    x = np.random.default_rng(1).normal(size=(tp.n_cameras, tp.cam_dof))
    y_dense = (S @ x.reshape(-1)).reshape(tp.n_cameras, tp.cam_dof)
    for route, ts in _port_systems(tp, te).items():
        y = tpcg.schur_matvec(ts, torch.from_numpy(x.T.copy()))
        np.testing.assert_allclose(y.numpy(), y_dense.T, rtol=1e-9, atol=1e-9, err_msg=route)


@pytest.mark.parametrize("warm,q_tol,terms", [
    (False, 0.0, 1), (True, 0.3, 1), (True, 0.0, 2),
])
def test_pcg_solve_matches_jax(both, warm, q_tol, terms):
    """Cold and warm starts, Q-stagnation stop, and the power-series
    preconditioner: same iterate, same iteration count."""
    (jp, je), (tp, te) = both
    js = jpcg.build_pcg_system(je, jnp.float64(LAM), jp.obs_cam, jp.obs_pt,
                               keep_D=terms > 1, **_tables(jp))
    x0 = 1e-3 * np.random.default_rng(2).normal(size=(tp.cam_dof, tp.n_cameras)) if warm else None
    kw = dict(tol=1e-6, max_iters=40, q_tol=q_tol, precond_terms=terms, return_iters=True)
    xj, nj = jpcg.pcg_solve(js, x0=None if x0 is None else jnp.asarray(x0), **kw)
    for route, ts in _port_systems(tp, te, keep_D=terms > 1).items():
        xt, nt = tpcg.pcg_solve(ts, x0=None if x0 is None else torch.from_numpy(x0), **kw)
        assert nt == int(nj) and 0 < nt < 40, (route, nt, int(nj))
        _close(xj, xt, rtol=1e-8, atol=1e-10)


def test_solve_step_pcg_cm3_matches_jax(both):
    (jp, je), (tp, te) = both
    rng = np.random.default_rng(3)
    dc_warm = 1e-3 * rng.normal(size=(tp.n_cameras, tp.cam_dof))
    dc_warm[0] = 0.0
    kw = dict(tol=1e-8, max_iters=60, q_tol=0.1)
    dcj, dpj, nj = jpcg.solve_step_pcg_cm3(
        je, jnp.float64(LAM), jp.obs_cam, jp.obs_pt, dc_warm=jnp.asarray(dc_warm),
        **_tables(jp), **kw)
    lam = torch.tensor(LAM, dtype=torch.float64)
    dct, dpt, nt = tpcg.solve_step_pcg_cm3(
        te, lam, tp.obs_cam, tp.obs_pt, dc_warm=torch.from_numpy(dc_warm),
        **_tables(tp), **kw)
    assert nt == int(nj)
    _close(dcj, dct, rtol=1e-8, atol=1e-10)
    _close(dpj, dpt, rtol=1e-8, atol=1e-10)
    # The std-layout entry returns the same step, points as [P, 3].
    dc2, dp2 = tpcg.solve_step_pcg(te, lam, tp.obs_cam, tp.obs_pt, tol=1e-8, max_iters=60)
    dcj2, dpj2 = jpcg.solve_step_pcg(je, jnp.float64(LAM), jp.obs_cam, jp.obs_pt,
                                     tol=1e-8, max_iters=60)
    _close(dcj2, dc2, rtol=1e-8, atol=1e-10)
    _close(dpj2, dp2, rtol=1e-8, atol=1e-10)


def test_non_spd_block_falls_back_to_damped_hcc(both):
    """A camera block whose Schur diagonal is not positive definite: JAX's
    Cholesky gives NaN and the preconditioner takes the damped Hcc block;
    the port must do the same without raising (cholesky_ex + NaN fill)."""
    (jp, je), (tp, te) = both
    je = je._replace(Hcc=je.Hcc.at[3].multiply(1e-6))
    te = te._replace(Hcc=te.Hcc.clone())
    te.Hcc[3] *= 1e-6
    js = jpcg.build_pcg_system(je, jnp.float64(LAM), jp.obs_cam, jp.obs_pt, **_tables(jp))
    ts = tpcg.build_pcg_system(te, torch.tensor(LAM, dtype=torch.float64),
                               tp.obs_cam, tp.obs_pt, **_tables(tp))
    _close(js.M_inv, ts.M_inv)
    np.testing.assert_allclose(ts.M_inv[3].numpy(), np.linalg.inv(ts.Hcc_aug[3].numpy()),
                               rtol=1e-8)
    assert torch.isfinite(ts.M_inv).all()
