"""PyTorch port vs the JAX package: component-major normal equations, Schur
reduction, damped step, model reduction and gradient norm
(``solver/schur_cm.py``), and ``schur.augment_block_diag``.

Both packages start from the same Jacobians (the JAX package's, handed to
the port as numpy arrays), in f64 on the CPU.  The reduction sums in other
orders (one-hot matmul, batched products), so the tolerance is rtol/atol
1e-10 rather than 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysfm_tpu.pipeline import synthetic as jsyn
from pysfm_tpu.problem import problem as jprob
from pysfm_tpu.solver import schur as jschur
from pysfm_tpu.solver import schur_cm as jcm
from pysfm_tpu_torch.solver import schur as tschur
from pysfm_tpu_torch.solver import schur_cm as tcm

torch.set_num_threads(2)
TOL = dict(rtol=1e-10, atol=1e-10)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b):
    np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def _inputs(model="pose", robust="huber", seed=2):
    p = jsyn.make_scene(
        6, 80, camera_model=model, noise_px=1.0, outlier_frac=0.1,
        outlier_px=20.0, robust=robust, robust_scale=2.0, seed=seed,
        visibility=0.8, dtype=np.float64,
    ).problem
    r, Jc, Jp, w = jprob.residuals_and_jacobians(p)
    M = p.n_obs
    cm = (r.T, Jc.reshape(M, -1).T, Jp.reshape(M, 6).T, w)
    tables = (p.obs_cam, p.obs_pt, p.pt_obs, p.pt_obs_mask)
    return p, cm, tables


def _both_eqs(p, cm):
    j = jcm.build_normal_equations_cm(*cm, p.obs_cam, p.pt_obs, p.pt_obs_mask,
                                      p.n_cameras)
    t = tcm.build_normal_equations_cm(
        *map(_t, cm), _t(p.obs_cam), _t(p.pt_obs), _t(p.pt_obs_mask),
        p.n_cameras,
    )
    return j, t


@pytest.mark.parametrize("model", ["pose", "pose_k", "bal"])
def test_normal_equations_match(model):
    p, cm, _ = _inputs(model)
    j, t = _both_eqs(p, cm)
    for name in jcm.NormalEqsCM._fields:
        _close(getattr(j, name), getattr(t, name))
    _close(jcm.grad_inf_cm(j), tcm.grad_inf_cm(t))


@pytest.mark.parametrize("robust", ["huber", "cauchy"])
def test_reduce_and_step_match(robust):
    p, cm, (obs_cam, obs_pt, pt_obs, mask) = _inputs("pose", robust, seed=3)
    j, t = _both_eqs(p, cm)
    lam = 1e-3
    sj = jcm.reduce_cm(j, jnp.float64(lam), obs_pt, pt_obs, mask, obs_cam)
    st = tcm.reduce_cm(t, torch.tensor(lam, dtype=torch.float64), _t(obs_pt),
                       _t(pt_obs), _t(mask), _t(obs_cam))
    for name in jcm.SchurSystemCM._fields:
        _close(getattr(sj, name), getattr(st, name))

    dcj, dpj = jcm.solve_step_cm(j, jnp.float64(lam), obs_cam, obs_pt, pt_obs, mask)
    dct, dpt = tcm.solve_step_cm(t, torch.tensor(lam, dtype=torch.float64),
                                 _t(obs_cam), _t(obs_pt), _t(pt_obs), _t(mask))
    _close(dcj, dct)
    _close(dpj, dpt)
    _close(jcm.back_substitute_cm(sj, dcj), tcm.back_substitute_cm(st, dct))
    _close(jcm.predicted_reduction_cm(j, jnp.float64(lam), dcj, dpj),
           tcm.predicted_reduction_cm(t, torch.tensor(lam, dtype=torch.float64),
                                      dct, dpt))


def test_point_block_helpers_match(rng):
    A = rng.normal(size=(3, 3, 40))
    H = np.einsum("ikp,jkp->ijp", A, A) + 0.1 * np.eye(3)[..., None]
    h6 = np.stack([H[a, b] for a, b in jcm._TRI])
    h6[:, :3] = 0.0  # unobserved points: unit fill
    for lam in (0.0, 1e-2):
        aj = jcm._augment6(jnp.asarray(h6), lam)
        at = tcm._augment6(_t(h6), lam)
        _close(aj, at)
        _close(jcm._inv_lower6(jcm._chol6(aj)), tcm._inv_lower6(tcm._chol6(at)))
    Hc = np.einsum("cij,ckj->cik", A, A)
    Hc[0] = 0.0  # gauge-fixed camera: unit fill
    _close(jschur.augment_block_diag(jnp.asarray(Hc), 1e-3),
           tschur.augment_block_diag(_t(Hc), 1e-3))


def test_non_spd_system_gives_nan_step():
    """A non-SPD reduced system: JAX's cho_factor yields NaN; the port must
    too (and not raise), so the LM loop rejects the step the same way."""
    p, cm, (obs_cam, obs_pt, pt_obs, mask) = _inputs(seed=4)
    j, t = _both_eqs(p, cm)
    j = j._replace(Hcc=-j.Hcc)
    t = t._replace(Hcc=-t.Hcc)
    dcj, _ = jcm.solve_step_cm(j, jnp.float64(1e-3), obs_cam, obs_pt, pt_obs, mask)
    dct, dpt = tcm.solve_step_cm(t, torch.tensor(1e-3, dtype=torch.float64),
                                 _t(obs_cam), _t(obs_pt), _t(pt_obs), _t(mask))
    assert np.isnan(np.asarray(dcj)).all()
    assert torch.isnan(dct).all() and torch.isnan(dpt).all()
