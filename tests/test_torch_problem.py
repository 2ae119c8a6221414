"""PyTorch port vs the JAX package: problem building, residuals, cost,
Jacobians and the retraction.

Problems are made by the JAX package (or from one numpy seed by both) and
handed to the port through ``from_numpy``.  f64 on the CPU: rtol/atol 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysfm_tpu.pipeline import synthetic as jsyn
from pysfm_tpu.problem import problem as jprob
from pysfm_tpu_torch.problem import problem as tprob

torch.set_num_threads(2)
TOL = dict(rtol=1e-12, atol=1e-12)


def to_port(p, dtype=None):
    """The JAX problem's fields as numpy arrays -> the port's problem."""
    arrays = {k: np.asarray(getattr(p, k)) for k in tprob.FIELDS}
    return tprob.from_numpy(arrays, p.camera_model, p.robust, "cpu", dtype)


def _close(a, b, **tol):
    np.testing.assert_allclose(b.numpy(), np.asarray(a), **(tol or TOL))


def _scene(model="pose", robust="huber", **kw):
    base = dict(noise_px=1.0, outlier_frac=0.1, outlier_px=30.0,
                robust_scale=2.0, seed=3, visibility=0.7, dtype=np.float64)
    base.update(kw)
    return jsyn.make_scene(5, 60, camera_model=model, robust=robust, **base)


def test_from_numpy_keeps_every_field():
    p = _scene().problem
    tp = to_port(p)
    for k in tprob.FIELDS:
        a, b = np.asarray(getattr(p, k)), getattr(tp, k).numpy()
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert (tp.n_cameras, tp.n_points, tp.n_obs, tp.cam_dof) == (
        p.n_cameras, p.n_points, p.n_obs, p.cam_dof)
    assert tp.dtype == torch.float64 and tp.to("cpu").device.type == "cpu"
    assert to_port(p, np.float32).X.dtype == torch.float32


def test_make_problem_matches_jax(rng):
    """Same raw inputs (unsorted, with zero-weight rows) -> same tables."""
    C, P, M = 4, 30, 200
    R = np.tile(np.eye(3), (C, 1, 1))
    t = rng.normal(size=(C, 3))
    intr = np.tile([800.0, 800.0, 320.0, 240.0], (C, 1))
    X = rng.normal(size=(P, 3))
    cam = rng.integers(0, C, M)
    pt = rng.integers(0, P, M)
    uv = rng.normal(size=(M, 2))
    w = (rng.random(M) > 0.1).astype(float)
    kw = dict(robust="cauchy", robust_scale=3.0, obs_w=w)
    a = jprob.make_problem(R, t, intr, X, cam, pt, uv, **kw)
    b = tprob.make_problem(R, t, intr, X, cam, pt, uv, device="cpu", **kw)
    for k in tprob.FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, k)),
                                      getattr(b, k).numpy(), err_msg=k)
    with pytest.raises(ValueError):
        tprob.make_problem(R, t, intr[:, :3], X, cam, pt, uv, device="cpu")
    with pytest.raises(ValueError):
        tprob.make_problem(R, t, intr, X, cam, pt, uv, max_track=1, device="cpu")


@pytest.mark.parametrize("model", ["pose", "pose_k", "bal"])
@pytest.mark.parametrize("robust", ["gaussian", "huber", "cauchy"])
def test_residuals_cost_jacobians_match_jax(model, robust):
    p = _scene(model, robust).problem
    tp = to_port(p)
    _close(jprob.residuals(p), tprob.residuals(tp))
    _close(jprob.cost(p), tprob.cost(tp))
    for a, b in zip(jprob.residuals_and_jacobians(p),
                    tprob.residuals_and_jacobians(tp)):
        _close(a, b)


@pytest.mark.parametrize("model", ["pose", "bal"])
def test_apply_update_matches_jax(rng, model):
    p = _scene(model).problem
    tp = to_port(p)
    dc = 0.01 * rng.normal(size=(p.n_cameras, p.cam_dof))
    dc[0] = 0.0
    dp = 0.01 * rng.normal(size=(p.n_points, 3))
    a = jprob.apply_update(p, jnp.asarray(dc), jnp.asarray(dp))
    b = tprob.apply_update(tp, torch.from_numpy(dc), torch.from_numpy(dp))
    for k in ("R", "t", "intr", "X"):
        _close(getattr(a, k), getattr(b, k))
    # The port returns a new problem and leaves its input as it was.
    np.testing.assert_array_equal(tp.X.numpy(), np.asarray(p.X))
