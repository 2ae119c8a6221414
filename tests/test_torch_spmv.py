"""The pcg route's kernel module (``solver/kernels/spmv.py``) against the JAX
package's Pallas kernels (``pallas_spmv``, in interpret mode as
``tests/test_spmv.py`` runs them) and against the plain JAX twins (K_D's
plain version against the XLA reference alone: no interpret-mode call).

On the CPU every wrapper runs its kernel's plain version; this is where
their arithmetic and outputs are held to the TPU kernels.  The CUDA kernels
are compared with the plain versions on the card by ``chip_smoke.py``.
Only layout-free outputs are compared: u, y, Hcc, g_c, hpp6, g_p, D, the
cost, and ``b_rows`` after ``permute_b_rows`` into the JAX grouped order.
Tolerances: f32 against Pallas, those of ``test_spmv.py`` (2e-4 relative,
3e-4 for D; the sums run in other orders), with an absolute floor of 1e-5
of the output's largest entry: an f32 residual is exact only to about one
ulp of the pixel coordinate (3e-5 px at 400 px), the gradients multiply it
by Jacobian entries of ~1e2, and a gradient entry can be the small
difference of terms far larger than itself; f64 against the plain JAX
twins, 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysfm_tpu.pipeline import synthetic as jsyn
from pysfm_tpu.problem import cm as jcm
from pysfm_tpu.problem import grouped
from pysfm_tpu.solver import pcg as jpcg
from pysfm_tpu.solver import scale as jscale
from pysfm_tpu.solver.kernels import pallas_spmv
from pysfm_tpu.solver.lm import make_grouped_ops as jmake_grouped_ops
from pysfm_tpu_torch.pipeline import synthetic as tsyn
from pysfm_tpu_torch.problem import cm as tcm
from pysfm_tpu_torch.solver import scale as tscale
from pysfm_tpu_torch.solver.kernels import spmv
from pysfm_tpu_torch.solver.lm import make_grouped_ops

torch.set_num_threads(2)
F32 = dict(rtol=2e-4, atol=2e-4)
F64 = dict(rtol=1e-10, atol=1e-10)


def _f32_close(got, ref, rtol=2e-4, atol=1e-4, err_msg=""):
    ref = np.asarray(ref)
    floor = max(atol, 1e-5 * float(np.max(np.abs(ref), initial=0.0)))
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol, atol=floor,
                               err_msg=err_msg)


def _random_incidence(rng, C, P, mean_track=4, cp=9):
    """Random BA-like visibility, point-sorted; every point sees >= 2
    cameras (as ``test_spmv._random_incidence``)."""
    cams, pts = [], []
    for p in range(P):
        k = min(2 + rng.poisson(mean_track - 2), C)
        for c in rng.choice(C, size=k, replace=False):
            cams.append(c)
            pts.append(p)
    obs_cam = np.asarray(cams, np.int32)
    obs_pt = np.asarray(pts, np.int32)
    o = np.argsort(obs_pt, kind="stable")
    B = rng.standard_normal((3 * cp, obs_cam.shape[0])).astype(np.float32)
    return obs_cam[o], obs_pt[o], B


def _jax_ops(obs_cam, obs_pt, B, C, P, superstep):
    """JAX grouped operands with ``B`` permuted into the grouped stream,
    padded to a block multiple of ``superstep``."""
    meta = grouped.build_grouped(obs_cam, obs_pt, C, P)
    NB0 = meta.block_group.shape[0]
    NB = -(-NB0 // superstep) * superstep
    if NB > NB0:
        meta = grouped._append_pad_blocks(meta, NB)
    b_rows = pallas_spmv.permute_b_rows(jnp.asarray(B), jnp.asarray(meta.order))
    return pallas_spmv.device_grouped(meta, b_rows).replace(superstep=superstep)


def _port_ops(obs_cam, obs_pt, B, C, P):
    M = obs_cam.shape[0]
    z = torch.zeros(M, dtype=torch.float32)
    ops = spmv.grouped_ops(torch.from_numpy(obs_cam), torch.from_numpy(obs_pt),
                           C, P, z, z, z, torch.float32)
    return ops.replace(b_rows=torch.from_numpy(B))


@pytest.mark.parametrize("C,P", [(5, 40), (130, 300)])
def test_hcpT_x_and_hcp_w_match_pallas(rng, C, P):
    """Against K_A / K_B (superstep 1) at both sizes and K_A2 / K_B2
    (superstep 4) at the size that spans two 128-camera groups; then the
    f64 plain versions against the JAX segment-sum operator."""
    cp = 9
    obs_cam, obs_pt, B = _random_incidence(rng, C, P, cp=cp)
    x = rng.standard_normal((cp, C)).astype(np.float32)
    w3 = rng.standard_normal((3, P)).astype(np.float32)
    ops = _port_ops(obs_cam, obs_pt, B, C, P)
    launches = dict(spmv.LAUNCHES)
    u = spmv.hcpT_x(ops, torch.from_numpy(x), cp=cp)
    y = spmv.hcp_w(ops, torch.from_numpy(w3), C, cp=cp)
    assert spmv.LAUNCHES == launches  # CPU tensors never launch a kernel
    assert u.shape == (3, P) and y.shape == (cp, C)

    ss = [1, 4] if C > 128 else [1]
    for T in ss:
        jops = _jax_ops(obs_cam, obs_pt, B, C, P, T)
        if T == 1:
            uj = pallas_spmv.hcpT_x_grouped(jops, jnp.asarray(x), cp=cp, interpret=True)
            yj = pallas_spmv.hcp_w_grouped(jops, jnp.asarray(w3), C, cp=cp, interpret=True)
        else:
            uj = pallas_spmv.hcpT_x_grouped2(jops, jnp.asarray(x), cp=cp, interpret=True)
            yj = pallas_spmv.hcp_w_grouped2(jops, jnp.asarray(w3), C, cp=cp, interpret=True)
        np.testing.assert_allclose(u.numpy(), np.asarray(uj)[:, :P], **F32)
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), **F32)

    # f64: the plain versions against the JAX segment-sum route of pcg.py.
    _plain_products_match_jax_f64(obs_cam, obs_pt, B.astype(np.float64),
                                  x.astype(np.float64), w3.astype(np.float64), C, P)


def _plain_products_match_jax_f64(obs_cam, obs_pt, B, x, w3, C, P):
    """The f64 plain products against the JAX package's segment-sum
    operator (``pcg._hcpT_x`` / ``pcg._hcp_w``) to 1e-10; returns (u, y)."""
    cp = x.shape[0]
    jsys = jpcg.PCGSystem(
        Hcc_aug=jnp.zeros((C, cp, cp)), hinv6=jnp.zeros((6, P)),
        rhs=jnp.zeros((cp, C)), g_p=jnp.zeros((3, P)), M_inv=jnp.zeros((C, cp, cp)),
        Bp=None, camg=None, Bg=None, ptg=None, B_cm=jnp.asarray(B),
        obs_cam=jnp.asarray(obs_cam), obs_pt=jnp.asarray(obs_pt),
    )
    ops64 = _port_ops(obs_cam, obs_pt, B, C, P)
    u = spmv.hcpT_x(ops64, torch.from_numpy(x), cp=cp).numpy()
    y = spmv.hcp_w(ops64, torch.from_numpy(w3), C, cp=cp).numpy()
    np.testing.assert_allclose(u, np.asarray(jpcg._hcpT_x(jsys, jnp.asarray(x))), **F64)
    np.testing.assert_allclose(y, np.asarray(jpcg._hcp_w(jsys, jnp.asarray(w3), C)), **F64)
    return u, y


def _precond_diag_matches_jax_f64(obs_cam, obs_pt, B, hpp6, C, P, lam=1e-3):
    """The f64 ``precond_diag_plain`` against the segment-sum diagonal of
    the JAX package's ``pcg.build_pcg_system`` (its ``D_blk`` is
    ``sym(Hcc_aug - D)``; here Hcc = 0) to 1e-9; returns D."""
    cp = B.shape[0] // 3
    jeqs = jscale.ScaleEqs(Hcc=jnp.zeros((C, cp, cp)), g_c=jnp.zeros((C, cp)),
                           hpp6=jnp.asarray(hpp6), g_p=jnp.zeros((3, P)), B_cm=jnp.asarray(B))
    jsys = jpcg.build_pcg_system(jeqs, jnp.float64(lam), jnp.asarray(obs_cam),
                                 jnp.asarray(obs_pt), keep_D=True)
    hinv6 = tscale.sym6_inv(tscale.augment6(torch.from_numpy(hpp6), lam))
    D = spmv.precond_diag(_port_ops(obs_cam, obs_pt, B, C, P), hinv6, C, cp=cp).numpy()
    np.testing.assert_allclose(np.asarray(jsys.Hcc_aug) - 0.5 * (D + D.transpose(0, 2, 1)),
                               np.asarray(jsys.D_blk), rtol=1e-9, atol=1e-9)
    return D


@pytest.mark.parametrize("kind", ["empty_and_long_cameras", "point_seen_by_every_camera"])
def test_plain_products_on_plan_edges_match_jax(kind):
    """The same f64 check on the edge scenes of the CUDA kernels' plans
    (``synthetic.plan_edge_incidence``), and K_H's plain version against
    the JAX package's segment-sum diagonal there: an empty camera's y and D
    are 0, as is an unobserved point's u.  No interpret-mode call."""
    obs_cam, obs_pt, C, P = tsyn.plan_edge_incidence(kind)
    cp = 9
    rng = np.random.default_rng(3)
    B = rng.standard_normal((3 * cp, obs_cam.shape[0]))
    u, y = _plain_products_match_jax_f64(obs_cam, obs_pt, B, rng.standard_normal((cp, C)),
                                         rng.standard_normal((3, P)), C, P)
    A = rng.standard_normal((P, 3, 3))
    H = A @ A.transpose(0, 2, 1) + np.eye(3)
    hpp6 = np.stack([H[:, 0, 0], H[:, 1, 0], H[:, 1, 1], H[:, 2, 0], H[:, 2, 1], H[:, 2, 2]])
    D = _precond_diag_matches_jax_f64(obs_cam, obs_pt, B, hpp6, C, P)
    seen_c = np.bincount(obs_cam, minlength=C) > 0
    seen_p = np.bincount(obs_pt, minlength=P) > 0
    assert (~seen_c).any() or (~seen_p).any()
    assert (y[:, ~seen_c] == 0).all() and (u[:, ~seen_p] == 0).all()
    assert (D[~seen_c] == 0).all() and (np.abs(D[seen_c]).max(axis=(1, 2)) > 0).all()


@pytest.mark.parametrize("model", ["pose", "pose_k", "bal"])
@pytest.mark.parametrize("kind", ["empty_and_long_cameras", "point_seen_by_every_camera"])
def test_build_eqs_plain_on_plan_edges_matches_jax_f64(kind, model):
    """K_E's plain version on a scene built on the plans' edge incidences
    (``synthetic.plan_edge_scene``: empty cameras, cameras with more than one
    chunk, a point seen by every camera, an unobserved point) against the
    JAX package's ``build_normal_equations_scale_cm`` in f64."""
    tp = tsyn.plan_edge_scene(kind, camera_model=model, dtype=np.float64, device="cpu")
    jp = jcm.CMProblem(**{k: jnp.asarray(getattr(tp, k).numpy()) for k in tcm.FIELDS},
                       camera_model=model, robust=tp.robust)
    je = jscale.build_normal_equations_scale_cm(jp, 0)
    te, b_t, b_c = _port_build(tp, make_grouped_ops(tp))
    for name in ("Hcc", "g_c", "hpp6", "g_p"):
        np.testing.assert_allclose(getattr(te, name).numpy(), np.asarray(getattr(je, name)),
                                   **F64, err_msg=name)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(je.B_cm), **F64)
    empty = np.bincount(tp.obs_cam.numpy(), minlength=tp.n_cameras) == 0
    assert (te.Hcc.numpy()[empty] == 0).all() and (te.g_c.numpy()[empty] == 0).all()


def _bal_problems(dtype, model="pose", robust="huber", outlier_frac=0.0):
    """``test_spmv.py``'s scene (outliers only where asked for)."""
    jp = jsyn.make_bal_scene(
        6, 400, mean_track=4.0, max_track=8, camera_model=model, noise_px=0.5,
        outlier_frac=outlier_frac, seed=5, robust=robust, robust_scale=2.0,
        dtype=dtype, with_truth=False, layout="cm",
    ).problem
    arrays = {k: np.asarray(getattr(jp, k)) for k in tcm.FIELDS}
    return jp, tcm.from_numpy(arrays, model, robust, device="cpu")


def _port_build(tp, ops):
    return spmv.build_eqs(
        ops, tcm.cam_table(tp), tp.X3, tp.robust_scale, cp=tp.cam_dof,
        model=tp.camera_model, robust=tp.robust, n_cameras=tp.n_cameras,
        n_points=tp.n_points,
    )


def test_build_eqs_precond_cost_match_pallas():
    """K_E (+ bf16 rows), K_H and K_C in f32 against the Pallas kernels."""
    jp, tp = _bal_problems(np.float32)
    gops = jmake_grouped_ops(jp)
    eqs_k, b_k = pallas_spmv.build_eqs_grouped(
        gops, jcm.cam_table(jp), jp.X3, jp.robust_scale, cp=jp.cam_dof,
        model=jp.camera_model, robust=jp.robust, n_cameras=jp.n_cameras,
        n_points=jp.n_points, interpret=True,
    )
    ops = make_grouped_ops(tp)
    eqs_t, b_t, _ = _port_build(tp, ops)
    assert eqs_t.B_cm is None and b_t.dtype == torch.float32
    for name in ("Hcc", "g_c", "hpp6", "g_p"):
        _f32_close(getattr(eqs_t, name).numpy(), getattr(eqs_k, name), err_msg=name)
    b_perm = np.asarray(pallas_spmv.permute_b_rows(jnp.asarray(b_t.numpy()), gops.order))
    _f32_close(b_perm, b_k, atol=1e-5)

    # bf16 storage: the Pallas kernel stores its f32 row value rounded to
    # bf16, so its bf16 rows are b_k rounded; the port's must be within one
    # bf16 ulp of them (the f32 values differ in the last bits).
    ops16 = make_grouped_ops(tp, rows_dtype=torch.bfloat16)
    _, b16, _ = _port_build(tp, ops16)
    assert b16.dtype == torch.bfloat16
    ref16 = np.asarray(jnp.asarray(b_k).astype(jnp.bfloat16).astype(jnp.float32))
    got16 = np.asarray(pallas_spmv.permute_b_rows(
        jnp.asarray(b16.float().numpy()), gops.order))
    mag = np.maximum(np.abs(ref16), np.abs(got16))
    ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7), 0.0)
    assert (np.abs(got16 - ref16) <= ulp).all()

    # K_H from the same rows and point-block inverses.
    hinv6 = jscale.sym6_inv(jscale.augment6(eqs_k.hpp6, jnp.float32(1e-3)))
    D_k = pallas_spmv.precond_diag_grouped(
        gops.replace(b_rows=b_k), hinv6, jp.n_cameras, cp=jp.cam_dof, interpret=True)
    D_t = spmv.precond_diag(ops.replace(b_rows=b_t), torch.from_numpy(np.array(hinv6)),
                            tp.n_cameras, cp=tp.cam_dof)
    assert D_t.shape == (tp.n_cameras, tp.cam_dof, tp.cam_dof)
    _f32_close(D_t.numpy(), D_k, rtol=3e-4)

    c_k = pallas_spmv.cost_grouped(
        gops, jcm.cam_table(jp), jp.X3, jp.robust_scale, model=jp.camera_model,
        robust=jp.robust, interpret=True)
    c_t = spmv.cost(ops, tcm.cam_table(tp), tp.X3, tp.robust_scale,
                    model=tp.camera_model, robust=tp.robust)
    np.testing.assert_allclose(float(c_t), float(c_k), rtol=2e-5)


@pytest.mark.parametrize("model", ["pose", "pose_k", "bal"])
@pytest.mark.parametrize("robust", ["gaussian", "huber", "cauchy"])
def test_plain_versions_match_jax_scale_f64(model, robust):
    """K_E's and K_C's plain versions against ``scale.py`` (the JAX plain
    twin), K_H's against the segment-sum diagonal of ``pcg.py``, in f64."""
    jp, tp = _bal_problems(np.float64, model, robust, outlier_frac=0.05)
    je = jscale.build_normal_equations_scale_cm(jp, 0)
    ops = make_grouped_ops(tp)
    assert ops.rows_dtype == torch.float64
    te, b_t, _ = _port_build(tp, ops)
    for name in ("Hcc", "g_c", "hpp6", "g_p"):
        np.testing.assert_allclose(getattr(te, name).numpy(), np.asarray(getattr(je, name)),
                                   **F64, err_msg=name)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(je.B_cm), **F64)
    np.testing.assert_allclose(
        float(spmv.cost(ops, tcm.cam_table(tp), tp.X3, tp.robust_scale,
                        model=model, robust=robust)),
        float(jscale.cost_scale_cm(jp, 0)), rtol=1e-10)

    lam = 1e-3
    jsys = jpcg.build_pcg_system(je, jnp.float64(lam), jp.obs_cam, jp.obs_pt, keep_D=True)
    Hcc_aug = np.asarray(jsys.Hcc_aug)
    D_t = spmv.precond_diag(ops.replace(b_rows=b_t), tscale.sym6_inv(
        tscale.augment6(te.hpp6, lam)), tp.n_cameras, cp=tp.cam_dof).numpy()
    D_ref = np.asarray(jsys.D_blk)          # = sym(Hcc_aug - D)
    np.testing.assert_allclose(Hcc_aug - 0.5 * (D_t + D_t.transpose(0, 2, 1)), D_ref,
                               rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("model", ["pose", "pose_k", "bal"])
def test_payload_b_plain_matches_jax_reference(model):
    """K_D's plain version against the reference JAX's own K_D test holds
    the Pallas kernel to (``scale.build_normal_equations_scale_cm(p,
    0).B_cm``) in f64, and bitwise against the rows of the port's
    ``build_eqs_plain``; on CPU tensors the wrapper launches nothing and
    stores ``ops.rows_dtype``."""
    jp, tp = _bal_problems(np.float64, model, "cauchy", outlier_frac=0.05)
    ref = np.asarray(jscale.build_normal_equations_scale_cm(jp, 0).B_cm)
    ops = make_grouped_ops(tp)
    args = (ops, tcm.cam_table(tp), tp.X3, tp.robust_scale)
    kw = dict(cp=tp.cam_dof, model=model, robust=tp.robust)
    launches = dict(spmv.LAUNCHES)
    b = spmv.payload_b(*args, **kw)
    assert spmv.LAUNCHES == launches
    assert b.shape == (3 * tp.cam_dof, tp.n_obs) and b.dtype == torch.float64
    np.testing.assert_allclose(b.numpy(), ref, rtol=1e-12, atol=1e-12)
    _, b_e, _ = spmv.build_eqs_plain(*args, **kw, n_cameras=tp.n_cameras, n_points=tp.n_points)
    assert torch.equal(b, b_e)
    b16 = spmv.payload_b(ops.replace(rows_dtype=torch.bfloat16), *args[1:], **kw)
    assert torch.equal(b16, b.to(torch.bfloat16))


def test_grouped_ops_layout(rng):
    C, P = 7, 50
    obs_cam, obs_pt, B = _random_incidence(rng, C, P)
    ops = _port_ops(obs_cam, obs_pt, B, C, P)
    assert (ops.n_cameras, ops.n_points, ops.n_obs) == (C, P, obs_cam.shape[0])
    pt_ptr, cam_ptr = ops.pt_ptr.numpy(), ops.cam_ptr.numpy()
    perm = ops.cam_perm.numpy()
    assert ops.pt_ptr.dtype == ops.cam_perm.dtype == torch.int32
    for p in range(P):
        assert (obs_pt[pt_ptr[p]:pt_ptr[p + 1]] == p).all()
    np.testing.assert_array_equal(perm, np.argsort(obs_cam, kind="stable"))
    for c in range(C):
        sl = perm[cam_ptr[c]:cam_ptr[c + 1]]
        assert (obs_cam[sl] == c).all() and (np.diff(sl) > 0).all()
    with pytest.raises(ValueError, match="sorted by point"):
        spmv.grouped_ops(torch.from_numpy(obs_cam), torch.from_numpy(obs_pt[::-1].copy()),
                         C, P, ops.u, ops.v, ops.w, torch.float32)


def test_dispatch_is_by_device(rng):
    """Neither CPU nor CUDA: the wrappers refuse rather than guess; unbuilt
    rows are refused too."""
    C, P, cp = 5, 40, 9
    obs_cam, obs_pt, B = _random_incidence(rng, C, P, cp=cp)
    ops = _port_ops(obs_cam, obs_pt, B, C, P)
    with pytest.raises(ValueError, match="no kernel for device"):
        spmv.hcpT_x(ops, torch.zeros((cp, C), device="meta"), cp=cp)
    with pytest.raises(ValueError, match="no kernel for device"):
        spmv.hcp_w(ops, torch.zeros((3, P), device="meta"), C, cp=cp)
    with pytest.raises(ValueError, match="not built"):
        spmv.precond_diag(ops.replace(b_rows=None), torch.zeros((6, P)), C, cp=cp)
