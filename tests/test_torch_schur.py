"""PyTorch port vs the JAX package: standard-layout normal equations, Schur
reduction, damped step and model reduction (``solver/schur.py``), the
standard-layout entries of ``solver/scale.py``, and ``solver/pcg.py`` on a
standard-layout ``NormalEqs``.

Both packages start from the same Jacobians (the JAX package's, handed to
the port as numpy arrays), in f64 on the CPU.  The normal equations are
the same products summed in other orders: rtol/atol 1e-12.  The closed-form
3x3 helpers are elementwise: 1e-12.  The reduction, the dense Cholesky
solve and the model reduction go through more sums: 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysfm_tpu.pipeline import synthetic as jsyn
from pysfm_tpu.problem import problem as jprob
from pysfm_tpu.solver import pcg as jpcg
from pysfm_tpu.solver import scale as jscale
from pysfm_tpu.solver import schur as jschur
from pysfm_tpu_torch.problem import problem as tprob
from pysfm_tpu_torch.solver import pcg as tpcg
from pysfm_tpu_torch.solver import scale as tscale
from pysfm_tpu_torch.solver import schur as tschur

torch.set_num_threads(2)
EXACT = dict(rtol=1e-12, atol=1e-12)
TOL = dict(rtol=1e-10, atol=1e-10)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(b.numpy(), np.asarray(a), **tol)


def _problem(model="pose", robust="huber", seed=2):
    return jsyn.make_scene(
        5, 80, camera_model=model, noise_px=1.0, outlier_frac=0.1,
        outlier_px=20.0, robust=robust, robust_scale=2.0, seed=seed,
        visibility=0.8, dtype=np.float64,
    ).problem


def _to_port(p):
    arrays = {k: np.asarray(getattr(p, k)) for k in tprob.FIELDS}
    return tprob.from_numpy(arrays, p.camera_model, p.robust, device="cpu")


def _eqs_both(p, tables: bool):
    lin = [np.asarray(a) for a in jprob.residuals_and_jacobians(p)]
    idx = [np.asarray(p.obs_cam), np.asarray(p.obs_pt)]
    kw_j = dict(pt_obs=p.pt_obs, pt_obs_mask=p.pt_obs_mask) if tables else {}
    kw_t = (dict(pt_obs=_t(p.pt_obs), pt_obs_mask=_t(p.pt_obs_mask))
            if tables else {})
    je = jschur.build_normal_equations(
        *map(jnp.asarray, lin + idx), p.n_cameras, p.n_points, **kw_j)
    te = tschur.build_normal_equations(
        *map(_t, lin + idx), p.n_cameras, p.n_points, **kw_t)
    return je, te, kw_j, kw_t


@pytest.mark.parametrize("model", ["pose", "bal"])
@pytest.mark.parametrize("tables", [True, False])
def test_normal_equations_and_step_match_jax(model, tables):
    """Both regimes (visibility tables, segment sums): the equations to
    1e-12, the Schur system, step and model reduction to 1e-10."""
    p = _problem(model)
    je, te, kw_j, kw_t = _eqs_both(p, tables)
    for name in je._fields:
        _close(getattr(je, name), getattr(te, name), EXACT)

    lam = 1e-3
    oc, op = p.obs_cam, p.obs_pt
    js = jschur.reduce_dense(je, jnp.float64(lam), oc, op, **kw_j)
    ts = tschur.reduce_dense(te, torch.tensor(lam, dtype=torch.float64),
                             _t(oc), _t(op), **kw_t)
    for name in js._fields:
        _close(getattr(js, name), getattr(ts, name))
    jdc, jdp = jschur.solve_step_dense(je, jnp.float64(lam), oc, op, **kw_j)
    tdc, tdp = tschur.solve_step_dense(te, torch.tensor(lam, dtype=torch.float64),
                                       _t(oc), _t(op), **kw_t)
    _close(jdc, tdc)
    _close(jdp, tdp)
    _close(jschur.predicted_reduction(je, jnp.float64(lam), jdc, jdp),
           tschur.predicted_reduction(te, lam, tdc, tdp))
    assert float(tschur.predicted_reduction(te, lam, tdc, tdp)) > 0


def test_scatter_coupling_regimes_agree(rng):
    p = _problem("pose_k", "cauchy", seed=4)
    B = rng.standard_normal((p.n_obs, 10, 3))
    args = (_t(B), _t(p.obs_cam), _t(p.obs_pt), p.n_cameras, p.n_points)
    W_tab = tschur.scatter_coupling_dense(*args, _t(p.pt_obs), _t(p.pt_obs_mask))
    W_sc = tschur.scatter_coupling_dense(*args)
    _close(jschur.scatter_coupling_dense(jnp.asarray(B), p.obs_cam, p.obs_pt,
                                         p.n_cameras, p.n_points), W_sc, EXACT)
    np.testing.assert_allclose(W_tab.numpy(), W_sc.numpy(), **EXACT)


def test_closed_form_3x3_match_jax(rng):
    A = rng.standard_normal((64, 3, 3))
    spd = np.einsum("nij,nkj->nik", A, A) + 0.1 * np.eye(3)
    for fn in ("inv3x3", "chol3x3"):
        _close(getattr(jschur, fn)(jnp.asarray(spd)), getattr(tschur, fn)(_t(spd)), EXACT)
    L = np.asarray(jschur.chol3x3(jnp.asarray(spd)))
    _close(jschur.inv_lower3x3(jnp.asarray(L)), tschur.inv_lower3x3(_t(L)), EXACT)
    np.testing.assert_allclose(
        (tschur.inv3x3(_t(spd)) @ _t(spd)).numpy(), np.broadcast_to(np.eye(3), spd.shape),
        atol=1e-9)


def test_non_spd_system_gives_nan_step():
    """A reduced system that is not positive definite gives a NaN step, as
    the reference's cho_factor does; the LM loop then rejects it."""
    p = _problem()
    _, te, _, kw_t = _eqs_both(p, True)
    neg = te._replace(Hcc=-10.0 * te.Hcc - torch.eye(te.Hcc.shape[-1], dtype=te.Hcc.dtype))
    dc, dp = tschur.solve_step_dense(neg, torch.tensor(0.0, dtype=torch.float64),
                                     _t(p.obs_cam), _t(p.obs_pt), **kw_t)
    assert torch.isnan(dc).all() and torch.isnan(dp).all()


def test_scale_std_entries_and_pcg_on_normal_eqs_match_jax():
    """scale.py's standard-layout entries, and one pcg step taken from a
    standard-layout NormalEqs (the segment-sum route), against JAX."""
    p = _problem("bal", "huber", seed=6)
    tp = _to_port(p)
    je_s = jscale.build_normal_equations_scale(p, 0)
    te_s = tscale.build_normal_equations_scale(tp, 0)
    for name in je_s._fields:
        _close(getattr(je_s, name), getattr(te_s, name))
    _close(jscale.cost_scale(p, 0), tscale.cost_scale(tp, 0))

    je, te, _, _ = _eqs_both(p, True)
    lam = 1e-2
    kw = dict(tol=1e-12, max_iters=50)
    jdc, jdp = jpcg.solve_step_pcg(je, jnp.float64(lam), p.obs_cam, p.obs_pt, **kw)
    tdc, tdp = tpcg.solve_step_pcg(te, torch.tensor(lam, dtype=torch.float64),
                                   _t(p.obs_cam), _t(p.obs_pt), **kw)
    _close(jdc, tdc)
    _close(jdp, tdp)
    _close(jscale.predicted_reduction_scale(je_s, jnp.float64(lam), jdc, jdp),
           tscale.predicted_reduction_scale(te_s, lam, tdc, tdp))
