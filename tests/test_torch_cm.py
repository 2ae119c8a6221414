"""The component-major problem (``problem/cm.py``) and the BAL-scale scene
(``pipeline/synthetic.make_bal_scene``) against the JAX package's, on the
same inputs in f64: rtol/atol 1e-12 (the same arithmetic in the same order,
up to the last bit of library transcendentals).

Also: every entry point that makes a problem puts it on the card unless the
caller asks for the CPU.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysfm_tpu.pipeline import synthetic as jsyn
from pysfm_tpu.problem import cm as jcm
from pysfm_tpu_torch.pipeline import synthetic as tsyn
from pysfm_tpu_torch.problem import cm as tcm
from pysfm_tpu_torch.problem import problem as tprob

torch.set_num_threads(2)
TOL = dict(rtol=1e-12, atol=1e-12)


def to_port_cm(p, device="cpu"):
    arrays = {k: np.asarray(getattr(p, k)) for k in tcm.FIELDS}
    return tcm.from_numpy(arrays, p.camera_model, p.robust, device=device)


def _scene(model, robust, seed=3):
    return jsyn.make_scene(
        5, 60, camera_model=model, noise_px=1.0, outlier_frac=0.1,
        outlier_px=30.0, robust=robust, robust_scale=2.0, visibility=0.7,
        seed=seed, dtype=np.float64,
    )


def _close(a, b, **tol):
    np.testing.assert_allclose(b.numpy(), np.asarray(a), **(tol or TOL))


@pytest.mark.parametrize("model", ["pose", "pose_k", "bal"])
@pytest.mark.parametrize("robust", ["gaussian", "huber", "cauchy"])
def test_cm_problem_and_projection_match(model, robust):
    sc = _scene(model, robust)
    jp = jcm.from_problem(sc.problem)
    arrays = {k: np.asarray(getattr(sc.problem, k)) for k in tprob.FIELDS}
    tp = tcm.from_problem(tprob.from_numpy(arrays, model, robust, device="cpu"))
    for k in tcm.FIELDS:
        x, y = np.asarray(getattr(jp, k)), getattr(tp, k).numpy()
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(y, x, err_msg=k)
        assert getattr(tp, k).is_contiguous(), k
    assert (tp.n_cameras, tp.n_points, tp.n_obs, tp.cam_dof) == (
        jp.n_cameras, jp.n_points, jp.n_obs, jp.cam_dof)

    jt, tt = jcm.cam_table(jp), tcm.cam_table(tp)
    _close(jt, tt)
    cols_j, X_j = jt[:, jp.obs_cam], jp.X3[:, jp.obs_pt]
    cols_t, X_t = tt[:, tp.obs_cam.long()], tp.X3[:, tp.obs_pt.long()]
    for a, b in zip(jcm.project_cm(model, cols_j, X_j), tcm.project_cm(model, cols_t, X_t)):
        _close(a, b)
    uj, vj, Jcj, Jpj = jcm.project_jac_cm(model, cols_j, X_j)
    ut, vt, Jct, Jpt = tcm.project_jac_cm(model, cols_t, X_t)
    _close(uj, ut)
    _close(vj, vt)
    for i in range(2):
        assert len(Jct[i]) == len(Jcj[i]) == tp.cam_dof
        for a, b in zip(Jcj[i] + Jpj[i], Jct[i] + Jpt[i]):
            _close(a, b)

    rng = np.random.default_rng(1)
    dc = 1e-2 * rng.normal(size=(tp.n_cameras, tp.cam_dof))
    dp3 = 1e-2 * rng.normal(size=(3, tp.n_points))
    a = jcm.apply_update_cm(jp, jnp.asarray(dc), jnp.asarray(dp3))
    b = tcm.apply_update_cm(tp, torch.from_numpy(dc), torch.from_numpy(dp3))
    for k in ("R", "t", "intr", "X3"):
        _close(getattr(a, k), getattr(b, k))
    merged = tcm.merge_params(tprob.from_numpy(arrays, model, robust, device="cpu"), b)
    ref = jcm.merge_params(sc.problem, a)
    for k in ("R", "t", "intr", "X"):
        _close(getattr(ref, k), getattr(merged, k))


@pytest.mark.parametrize("layout", ["std", "cm"])
def test_make_bal_scene_matches_jax(layout):
    kw = dict(mean_track=4.0, max_track=8, camera_model="bal", noise_px=0.5,
              outlier_frac=0.05, robust="huber", robust_scale=2.0, seed=5,
              dtype=np.float64, layout=layout)
    a = jsyn.make_bal_scene(7, 90, **kw)
    b = tsyn.make_bal_scene(7, 90, device="cpu", **kw)
    fields = tcm.FIELDS if layout == "cm" else tprob.FIELDS
    kind = tcm.CMProblem if layout == "cm" else tprob.BundleProblem
    for pj, pt in ((a.truth, b.truth), (a.problem, b.problem)):
        assert isinstance(pt, kind)
        for k in fields:
            x, y = np.asarray(getattr(pj, k)), getattr(pt, k).numpy()
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_allclose(y, x, rtol=1e-12, atol=1e-9, err_msg=k)
    c = tsyn.make_bal_scene(7, 90, device="cpu", with_truth=False, **kw)
    assert c.truth is None


def test_make_cm_problem_and_from_numpy():
    """make_cm_problem on raw arrays == the JAX package's; from_numpy carries
    a JAX CMProblem across (f32 stays f32)."""
    sc = jsyn.make_bal_scene(5, 40, mean_track=3.0, max_track=5, seed=2,
                             dtype=np.float32, layout="cm")
    jp = sc.problem
    tp = to_port_cm(jp)
    assert tp.dtype == torch.float32 and tp.device.type == "cpu"
    for k in tcm.FIELDS:
        np.testing.assert_array_equal(getattr(tp, k).numpy(), np.asarray(getattr(jp, k)))
    rng = np.random.default_rng(0)
    C, P = 4, 30
    R = np.stack([np.eye(3)] * C)
    t = np.tile([0.0, 0.0, 5.0], (C, 1))
    intr = np.tile([800.0, 800.0, 320.0, 240.0], (C, 1))
    X = rng.uniform(-1, 1, size=(P, 3))
    cam = np.repeat(np.arange(C), P)
    pt = np.tile(np.arange(P), C)
    uv = rng.uniform(0, 640, size=(C * P, 2))
    a = jcm.make_cm_problem(R, t, intr, X, cam, pt, uv, robust="cauchy")
    b = tcm.make_cm_problem(R, t, intr, X, cam, pt, uv, robust="cauchy", device="cpu")
    for k in tcm.FIELDS:
        np.testing.assert_array_equal(getattr(b, k).numpy(), np.asarray(getattr(a, k)))
    assert b.robust == "cauchy" and b.to("cpu").robust == "cauchy"


def test_entry_points_default_to_the_card():
    """The card is the default device of every entry point that makes a
    problem; callers pass device="cpu" for the CPU (there is no fallback).
    Checked on the signatures, since this host has no card."""
    from pysfm_tpu_torch.solver import lm

    for fn in (tsyn.make_scene, tsyn.make_bal_scene, tprob.make_problem,
               tprob.from_numpy, tcm.from_numpy, tcm.make_cm_problem):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    # make_grouped_ops follows its problem: it has no device of its own.
    assert "device" not in inspect.signature(lm.make_grouped_ops).parameters
