"""PyTorch port vs the JAX package: SO(3), SE(3), projection models, robust
costs, and the evaluation metrics (``utils/metrics.py``).

Inputs come from a numpy seed and go through both packages as numpy
arrays.  Both run in f64 on the CPU, so they agree to roundoff: rtol/atol
1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysfm_tpu.geometry import projection as jproj
from pysfm_tpu.geometry import se3 as jse3
from pysfm_tpu.geometry import so3 as jso3
from pysfm_tpu.problem import robust as jrobust
from pysfm_tpu.utils import metrics as jmetrics
from pysfm_tpu_torch.geometry import projection as tproj
from pysfm_tpu_torch.geometry import se3 as tse3
from pysfm_tpu_torch.geometry import so3 as tso3
from pysfm_tpu_torch.problem import robust as trobust
from pysfm_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(2)
TOL = dict(rtol=1e-12, atol=1e-12)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _close(jax_out, torch_out, **tol):
    np.testing.assert_allclose(
        torch_out.numpy(), np.asarray(jax_out), **(tol or TOL)
    )


def _rotvecs(rng, n=64):
    """Axis-angle vectors: generic, tiny (Taylor branch) and near pi."""
    axes = rng.normal(size=(n, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    angles = np.concatenate([
        rng.uniform(0.0, 3.0, n - 16),
        rng.uniform(0.0, 1e-5, 8),                 # theta^2 < 1e-8
        np.pi - rng.uniform(1e-7, 1e-3, 8),
    ])
    return axes * angles[:, None]


def test_hat_vee(rng):
    w = rng.normal(size=(10, 3))
    _close(jso3.hat(jnp.asarray(w)), tso3.hat(_t(w)))
    W = rng.normal(size=(10, 3, 3))
    _close(jso3.vee(jnp.asarray(W)), tso3.vee(_t(W)))


@pytest.mark.parametrize("fn", ["exp", "log_of_exp", "quaternion"])
def test_so3_matches_jax(rng, fn):
    w = _rotvecs(rng)
    if fn == "exp":
        _close(jso3.exp(jnp.asarray(w)), tso3.exp(_t(w)))
        return
    R = np.asarray(jso3.exp(jnp.asarray(w)))
    if fn == "log_of_exp":
        _close(jso3.log(jnp.asarray(R)), tso3.log(_t(R)), rtol=1e-9, atol=1e-9)
        return
    _close(jso3.to_quaternion(jnp.asarray(R)), tso3.to_quaternion(_t(R)))
    q = rng.normal(size=(20, 4))
    _close(jso3.from_quaternion(jnp.asarray(q)), tso3.from_quaternion(_t(q)))


def test_normalize_matches_jax(rng):
    R = np.asarray(jso3.exp(jnp.asarray(_rotvecs(rng, 32))))
    R_noisy = R + 1e-3 * rng.normal(size=R.shape)
    _close(jso3.normalize(jnp.asarray(R_noisy)), tso3.normalize(_t(R_noisy)),
           rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("shape", [(7, 3), (4, 5, 4)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pr_unpr_match_jax(rng, shape, dtype):
    """Dehomogenize / homogenize as ``tests/test_geometry.py`` tests them,
    against the JAX functions on the same inputs (f32 to its roundoff)."""
    x = rng.normal(size=shape).astype(dtype)
    x[..., -1] += np.where(x[..., -1] >= 0, 1.0, -1.0)  # away from a zero divisor
    tol = TOL if dtype == np.float64 else dict(rtol=1e-6, atol=1e-6)
    tx = torch.from_numpy(x)
    got_pr, got_unpr = tproj.pr(tx), tproj.unpr(tx)
    assert got_pr.dtype == got_unpr.dtype == tx.dtype
    assert got_pr.shape == shape[:-1] + (shape[-1] - 1,)
    assert got_unpr.shape == shape[:-1] + (shape[-1] + 1,)
    _close(jproj.pr(jnp.asarray(x)), got_pr, **tol)
    _close(jproj.unpr(jnp.asarray(x)), got_unpr, **tol)
    _close(x, tproj.pr(tproj.unpr(tx)), **tol)


def _camera_inputs(rng, model, n=50):
    R = np.asarray(jso3.exp(jnp.asarray(rng.normal(scale=0.3, size=(n, 3)))))
    t = rng.normal(size=(n, 3))
    X = rng.normal(size=(n, 3))
    z = np.einsum("nij,nj->ni", R, X) + t
    # Keep points in front of the camera (+z pinhole, -z BAL).
    t[:, 2] += (-1.0 if model == "bal" else 1.0) * (np.abs(z[:, 2]) + 5.0)
    if model == "bal":
        intr = np.stack([800 + 10 * rng.normal(size=n),
                         1e-2 * rng.normal(size=n),
                         1e-3 * rng.normal(size=n)], axis=-1)
    else:
        intr = np.stack([800 + rng.normal(size=n), 790 + rng.normal(size=n),
                         320 + rng.normal(size=n), 240 + rng.normal(size=n)],
                        axis=-1)
    return R, t, intr, X


@pytest.mark.parametrize("model", ["pose", "pose_k", "bal"])
def test_projection_matches_jax(rng, model):
    args = _camera_inputs(rng, model)
    _close(jproj.project(model, *map(jnp.asarray, args)),
           tproj.project(model, *map(_t, args)))
    for a, b in zip(jproj.project_with_jac(model, *map(jnp.asarray, args)),
                    tproj.project_with_jac(model, *map(_t, args))):
        _close(a, b)
    assert tproj.CAM_DOF == jproj.CAM_DOF
    assert tproj.INTR_DIM == jproj.INTR_DIM


@pytest.mark.parametrize("kernel", ["gaussian", "huber", "cauchy"])
def test_robust_matches_jax(rng, kernel):
    s = np.concatenate([rng.uniform(0, 4, 50), rng.uniform(4, 400, 50)])
    scale = 2.0
    _close(jrobust.rho(kernel, jnp.asarray(s), scale),
           trobust.rho(kernel, _t(s), torch.tensor(scale, dtype=torch.float64)))
    _close(jrobust.weight(kernel, jnp.asarray(s), scale),
           trobust.weight(kernel, _t(s), scale))


def test_unknown_names_raise():
    with pytest.raises(ValueError):
        tproj.project("fisheye", *(torch.zeros(1, 3, 3),) * 4)
    with pytest.raises(ValueError):
        trobust.weight("tukey", torch.zeros(3), 1.0)


def test_precision_pins_full_f32(rng):
    from pysfm_tpu_torch.utils import precision as xp

    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    A, x = rng.normal(size=(4, 3, 3)), rng.normal(size=(4, 3))
    _close(np.einsum("bij,bj->bi", A, x), xp.matvec(_t(A), _t(x)))
    _close(A @ A, xp.matmul(_t(A), _t(A)))
    _close(np.einsum("bij->bji", A), xp.einsum("bij->bji", _t(A)))


@pytest.mark.parametrize("fn", ["transform", "inverse", "compose", "camera_center",
                                "retract", "exp"])
def test_se3_matches_jax(rng, fn):
    R = np.asarray(jso3.exp(jnp.asarray(_rotvecs(rng, 32))))
    t, X, dw = rng.normal(size=(32, 3)), rng.normal(size=(32, 3)), _rotvecs(rng, 32)
    args = {
        "transform": (R, t, X), "inverse": (R, t), "compose": (R, t, R[::-1], X),
        "camera_center": (R, t), "retract": (R, t, dw, X),
        "exp": (np.concatenate([dw, X], axis=-1),),
    }[fn]
    a = getattr(jse3, fn)(*map(jnp.asarray, args))
    b = getattr(tse3, fn)(*map(_t, args))
    for x, y in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
        _close(x, y)


def test_metrics_match_jax(rng):
    from pysfm_tpu.pipeline import synthetic as jsyn
    from pysfm_tpu_torch.problem import problem as tprob

    src = rng.normal(size=(20, 3))
    R = np.asarray(jso3.exp(jnp.asarray(rng.normal(size=3))))
    dst = 2.5 * src @ R.T + rng.normal(size=3) + 1e-3 * rng.normal(size=(20, 3))
    for scale in (True, False):
        for x, y in zip(jmetrics.umeyama(jnp.asarray(src), jnp.asarray(dst), scale),
                        tmetrics.umeyama(_t(src), _t(dst), scale)):
            _close(x, y)
        _close(jmetrics.ate_rmse(jnp.asarray(src), jnp.asarray(dst), scale),
               tmetrics.ate_rmse(_t(src), _t(dst), scale))
    Rs = np.asarray(jso3.exp(jnp.asarray(_rotvecs(rng, 24))))
    ts = rng.normal(size=(24, 3))
    _close(jmetrics.camera_centers(jnp.asarray(Rs), jnp.asarray(ts)),
           tmetrics.camera_centers(_t(Rs), _t(ts)))
    p = jsyn.make_scene(3, 40, noise_px=0.7, outlier_frac=0.1, seed=4).problem
    p = p.replace(obs_w=p.obs_w.at[:5].set(0.0))
    tp = tprob.from_numpy({k: np.asarray(getattr(p, k)) for k in tprob.FIELDS},
                          p.camera_model, p.robust, device="cpu")
    np.testing.assert_allclose(tmetrics.reprojection_rmse(tp),
                               jmetrics.reprojection_rmse(p), rtol=1e-12)
