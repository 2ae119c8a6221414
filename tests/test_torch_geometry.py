"""PyTorch port vs the JAX package: SO(3), projection models, robust costs.

Inputs come from a numpy seed and go through both packages as numpy
arrays.  Both run in f64 on the CPU, so they agree to roundoff: rtol/atol
1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysfm_tpu.geometry import projection as jproj
from pysfm_tpu.geometry import so3 as jso3
from pysfm_tpu.problem import robust as jrobust
from pysfm_tpu_torch.geometry import projection as tproj
from pysfm_tpu_torch.geometry import so3 as tso3
from pysfm_tpu_torch.problem import robust as trobust

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
