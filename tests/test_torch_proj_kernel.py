"""The projection/Jacobian kernel module (``solver/kernels/proj.py``) vs the
JAX package's Pallas kernel (``pallas_proj``, run in interpret mode as
``tests/test_pallas.py`` runs it).

On the CPU the wrappers run the kernel's plain PyTorch version; this is
where its arithmetic, output layouts and dispatch are held to the TPU
kernel.  The CUDA kernel itself is compared with the plain version on the
card by ``chip_smoke.py``.  f64: rtol/atol 1e-12.  f32: the bound of
``test_pallas.py`` (1e-4 of the largest entry), since the two round in
different orders.
"""

import numpy as np
import pytest
import torch

from pysfm_tpu.pipeline import synthetic as jsyn
from pysfm_tpu.solver.kernels import pallas_proj
from pysfm_tpu_torch.pipeline import synthetic as tsyn
from pysfm_tpu_torch.problem import problem as tprob
from pysfm_tpu_torch.solver.kernels import proj

torch.set_num_threads(2)
TOL = dict(rtol=1e-12, atol=1e-12)


def to_port(p):
    arrays = {k: np.asarray(getattr(p, k)) for k in tprob.FIELDS}
    return tprob.from_numpy(arrays, p.camera_model, p.robust, device="cpu")


def _scene(model, robust, n_cams=5, n_pts=101, dtype=np.float64, seed=3):
    return jsyn.make_scene(
        n_cams, n_pts, camera_model=model, noise_px=1.0, outlier_frac=0.1,
        outlier_px=30.0, robust=robust, robust_scale=2.0, seed=seed,
        dtype=dtype,
    ).problem


@pytest.mark.parametrize("model", ["pose", "pose_k", "bal"])
@pytest.mark.parametrize("robust", ["gaussian", "huber", "cauchy"])
def test_cm_matches_pallas_f64(model, robust):
    p = _scene(model, robust)
    launches = proj.LAUNCHES
    ref = pallas_proj.residuals_and_jacobians_pallas_cm(p, interpret=True)
    out = proj.residuals_and_jacobians_cm(to_port(p))
    for a, b in zip(ref, out):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    assert proj.LAUNCHES == launches  # CPU tensors never launch the kernel


@pytest.mark.parametrize("model", ["pose", "pose_k", "bal"])
def test_jax_signature_entries_match_pallas(model):
    """The gathered-operand entries (identity indices) and the std layout,
    on the first M = 37 observations (a ragged edge for both kernels)."""
    p = _scene(model, "cauchy", n_cams=4, n_pts=40, seed=8)
    m = 37
    Rg, tg, ig, Xg, free = pallas_proj._gathered_operands(p)
    jargs = [a[:m] for a in (Rg, tg, ig, Xg, p.obs_uv, p.obs_w, free)]
    targs = [torch.from_numpy(np.array(a)) for a in jargs]
    for jfn, tfn in (
        (pallas_proj.residuals_jacobians_weights_cm, proj.residuals_jacobians_weights_cm),
        (pallas_proj.residuals_jacobians_weights, proj.residuals_jacobians_weights),
    ):
        ref = jfn(model, "cauchy", *jargs, p.robust_scale, interpret=True)
        assert ref[-1].shape == (m,)
        out = tfn(model, "cauchy", *targs, float(p.robust_scale))
        for a, b in zip(ref, out):
            assert tuple(b.shape) == a.shape
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    ref = pallas_proj.residuals_and_jacobians_pallas(p, interpret=True)
    for a, b in zip(ref, proj.residuals_and_jacobians(to_port(p))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_ragged_m_and_fixed_camera():
    """M = 3 * 37 = 111 (no tile multiple); camera 0 is gauge-fixed."""
    p = jsyn.make_scene(3, 37, camera_model="pose", seed=5,
                        dtype=np.float64).problem
    rt, Jct, Jpt, wt = proj.residuals_and_jacobians_cm(to_port(p))
    assert rt.shape == (2, p.n_obs) and Jct.shape == (2 * p.cam_dof, p.n_obs)
    assert Jpt.shape == (6, p.n_obs) and wt.shape == (p.n_obs,)
    assert torch.isfinite(rt).all()
    fixed = np.asarray(p.obs_cam) == 0
    assert fixed.any() and (Jct[:, fixed] == 0).all() and (Jct[:, ~fixed] != 0).any()
    ref = pallas_proj.residuals_and_jacobians_pallas_cm(p, interpret=True)
    np.testing.assert_allclose(Jct.numpy(), np.asarray(ref[1]), **TOL)


def test_f32_close_to_pallas():
    p = _scene("pose", "huber", n_cams=4, n_pts=200, dtype=np.float32, seed=7)
    ref = pallas_proj.residuals_and_jacobians_pallas_cm(p, interpret=True)
    out = proj.residuals_and_jacobians_cm(to_port(p))
    for a, b in zip(ref, out):
        assert b.dtype == torch.float32
        scale = float(np.max(np.abs(np.asarray(a)))) + 1.0
        assert float(np.max(np.abs(b.numpy() - np.asarray(a)))) < 1e-4 * scale


def test_dispatch_is_by_device():
    """Neither CPU nor CUDA: the wrapper refuses rather than guessing."""
    tp = tsyn.make_scene(3, 20, seed=1, device="cpu").problem.to("meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        proj.residuals_and_jacobians_cm(tp)


def test_kernel_operands_are_the_problems_own_arrays():
    """The kernel reads the problem's arrays as they are (``cam_fixed`` as
    bool, no free flags computed per call), and the plain version on those
    operands equals ``proj_cm_plain`` with the free flags."""
    tp = tsyn.make_scene(4, 30, seed=2, device="cpu").problem
    args = proj._problem_args(tp)
    own = (tp.R, tp.t, tp.intr, tp.X, tp.obs_cam, tp.obs_pt, tp.obs_uv, tp.obs_w,
           tp.cam_fixed, tp.robust_scale)
    assert all(a is b for a, b in zip(args, own)) and len(args) == len(own)
    assert args[8].dtype == torch.bool and bool(args[8][0]) and not bool(args[8][1:].any())
    free = torch.logical_not(tp.cam_fixed).to(tp.dtype)
    ref = proj.proj_cm_plain(tp.camera_model, tp.robust, *args[:8], free, args[9])
    for a, b in zip(proj._plain(tp.camera_model, tp.robust, *args), ref):
        assert torch.equal(a, b)
    assert not bool(ref[1][:, tp.obs_cam == 0].any())  # the fixed camera's J_cam rows
