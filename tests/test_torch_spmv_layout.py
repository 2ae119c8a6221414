"""The layout of the CG products in ``solver/kernels/spmv.py``: the
camera-sorted copy of the coupling rows (``b_cam``), each camera-ordered
observation's point (``cam_pt``), and the static plans that cut the two
row streams into the pieces one block of ``hcp_w`` (chunks) or ``hcpT_x``
(tiles) owns; and the cost kernel's host-side scratch (its ticket counter
and the size of its partials).

The edge scenes are ``pipeline/synthetic.plan_edge_incidence``'s.  The CUDA
kernels run only on the card (``chip_smoke.py`` holds them to their plain
versions there, on these edge scenes too); here the plans are checked for
exact coverage (the plain products on the edge scenes are held to the JAX
package in ``test_torch_spmv.py``).  No interpret-mode Pallas call.
"""

import numpy as np
import pytest
import torch

from pysfm_tpu_torch.pipeline import synthetic as tsyn
from pysfm_tpu_torch.problem import cm as tcm
from pysfm_tpu_torch.solver import LMConfig, solve
from pysfm_tpu_torch.solver.kernels import spmv
from pysfm_tpu_torch.solver.lm import make_grouped_ops

torch.set_num_threads(2)


KINDS = tsyn.PLAN_EDGES[:3]
_incidence = tsyn.plan_edge_incidence


def _ops(obs_cam, obs_pt, C, P, dtype=torch.float64):
    z = torch.zeros(obs_cam.shape[0], dtype=torch.float32)
    return spmv.grouped_ops(torch.from_numpy(obs_cam), torch.from_numpy(obs_pt),
                            C, P, z, z, z, dtype)


@pytest.mark.parametrize("kind", KINDS)
def test_measurements_in_camera_order(kind):
    """K_E's camera pass reads u, v, w camera-sorted: ``u_cam`` is exactly
    ``u[cam_perm]`` (and so on), built once with the layout."""
    obs_cam, obs_pt, C, P = _incidence(kind)
    M = obs_cam.shape[0]
    rng = np.random.default_rng(1)
    u, v, w = (torch.from_numpy(rng.standard_normal(M).astype(np.float32)) for _ in range(3))
    ops = spmv.grouped_ops(torch.from_numpy(obs_cam), torch.from_numpy(obs_pt), C, P,
                           u, v, w, torch.float32)
    perm = ops.cam_perm.long()
    for name, ref in (("u_cam", u), ("v_cam", v), ("w_cam", w)):
        got = getattr(ops, name)
        assert got.dtype == torch.float32 and got.shape == (M,)
        assert torch.equal(got, ref[perm]), name


@pytest.mark.parametrize("kind", KINDS)
def test_cam_pt_is_obs_pt_in_camera_order(kind):
    obs_cam, obs_pt, C, P = _incidence(kind)
    ops = _ops(obs_cam, obs_pt, C, P)
    perm = ops.cam_perm.numpy()
    assert ops.cam_pt.dtype == torch.int32
    np.testing.assert_array_equal(ops.cam_pt.numpy(), obs_pt[perm])
    np.testing.assert_array_equal(obs_cam[perm], np.sort(obs_cam, kind="stable"))


@pytest.mark.parametrize("kind", KINDS)
def test_chunk_plan_covers_each_camera_once(kind):
    """hcp_w's chunks tile [0, M) in order; each lies inside one camera's
    range and holds at most HCP_W_CHUNK observations; camera c owns exactly
    the chunks that cover its range, none when it has no observations."""
    obs_cam, obs_pt, C, P = _incidence(kind)
    ops = _ops(obs_cam, obs_pt, C, P)
    off, cptr = ops.chunk_off.numpy(), ops.chunk_ptr.numpy()
    cam_ptr = ops.cam_ptr.numpy()
    assert ops.chunk_off.dtype == ops.chunk_ptr.dtype == torch.int32
    assert off[0] == 0 and off[-1] == obs_cam.shape[0]
    sizes = np.diff(off)
    assert (sizes > 0).all() and (sizes <= spmv.HCP_W_CHUNK).all()
    assert cptr[0] == 0 and cptr[-1] == off.shape[0] - 1
    for c in range(C):
        mine = off[cptr[c]:cptr[c + 1] + 1]
        if cam_ptr[c] == cam_ptr[c + 1]:
            assert cptr[c] == cptr[c + 1]
        else:
            assert mine[0] == cam_ptr[c] and mine[-1] == cam_ptr[c + 1]
    if kind == "empty_and_long_cameras":
        assert np.diff(cptr).tolist() == [2, 2, 0, 1, 0]


@pytest.mark.parametrize("kind", KINDS)
def test_tile_plan_covers_each_point_once_in_order(kind):
    """hcpT_x's tiles: consecutive point ranges covering [0, P) once; a tile
    of several points spans at most HCPT_X_TILE observations, and a point
    whose track is longer than half a tile is alone in its tile."""
    obs_cam, obs_pt, C, P = _incidence(kind)
    ops = _ops(obs_cam, obs_pt, C, P)
    tp, pt_ptr = ops.tile_pt.numpy(), ops.pt_ptr.numpy()
    assert ops.tile_pt.dtype == torch.int32
    assert tp[0] == 0 and tp[-1] == P and (np.diff(tp) > 0).all()
    track = np.diff(pt_ptr)
    for a, b in zip(tp[:-1], tp[1:]):
        if b - a > 1:
            assert pt_ptr[b] - pt_ptr[a] <= spmv.HCPT_X_TILE
            assert (track[a:b] <= spmv.HCPT_X_TILE // 2).all()
    lone = {int(a) for a, b in zip(tp[:-1], tp[1:]) if b - a == 1}
    assert set(np.flatnonzero(track > spmv.HCPT_X_TILE // 2).tolist()) <= lone
    if kind == "point_seen_by_every_camera":
        assert track[7] == C > spmv.HCPT_X_TILE and {7, 8} <= lone


@pytest.mark.parametrize("rows_dtype", [torch.float64, torch.bfloat16])
@pytest.mark.parametrize("model", ["pose", "pose_k", "bal"])
def test_build_eqs_plain_b_cam_is_b_rows_in_camera_order(model, rows_dtype):
    p = tsyn.make_bal_scene(6, 150, mean_track=4.0, max_track=6, camera_model=model,
                            robust="huber", robust_scale=2.0, seed=5, dtype=np.float64,
                            with_truth=False, layout="cm", device="cpu").problem
    ops = make_grouped_ops(p, rows_dtype=rows_dtype)
    eqs, b_rows, b_cam = spmv.build_eqs(
        ops, tcm.cam_table(p), p.X3, p.robust_scale, cp=p.cam_dof,
        model=model, robust=p.robust, n_cameras=p.n_cameras, n_points=p.n_points)
    assert b_cam.dtype == b_rows.dtype == rows_dtype
    assert b_cam.shape == b_rows.shape == (3 * p.cam_dof, p.n_obs)
    assert torch.equal(b_cam, b_rows[:, ops.cam_perm.long()])


@pytest.mark.parametrize("change", ["both", "b_rows_alone", "neither"])
def test_replace_carries_b_cam(change):
    """``replace`` keeps the plans and carries ``b_cam`` with the ``b_rows``
    it was stored with; new ``b_rows`` alone drop it, so that the ``hcp_w``
    kernel raises instead of reading another linearization's rows."""
    obs_cam, obs_pt, C, P = _incidence("random")
    ops = _ops(obs_cam, obs_pt, C, P)
    assert ops.b_rows is None and ops.b_cam is None
    b = torch.arange(3 * 6 * obs_cam.shape[0], dtype=torch.float64).reshape(18, -1)
    it = ops.replace(b_rows=b, b_cam=b[:, ops.cam_perm.long()])
    assert it.b_rows is b and torch.equal(it.b_cam, b[:, ops.cam_perm.long()])
    b2 = b.flip(1).contiguous()
    if change == "both":
        new = it.replace(b_rows=b2, b_cam=b2[:, ops.cam_perm.long()])
        assert new.b_rows is b2 and torch.equal(new.b_cam, b2[:, ops.cam_perm.long()])
    elif change == "b_rows_alone":
        new = it.replace(b_rows=b2)
        assert new.b_rows is b2 and new.b_cam is None
    else:
        new = it.replace(rows_dtype=torch.float32)
        assert new.b_rows is it.b_rows and new.b_cam is it.b_cam
    assert new.tile_pt is ops.tile_pt and new.chunk_off is ops.chunk_off
    assert all(getattr(new, k) is getattr(ops, k) for k in ("u_cam", "v_cam", "w_cam"))


def test_lm_loop_hands_both_row_copies_to_the_products(monkeypatch):
    """Every product of a pcg solve with kernel operands (rebuilds and
    reused linearizations alike) sees ``b_cam == b_rows[:, cam_perm]``;
    ``hcp_w`` and ``precond_diag``, whose kernels read ``b_cam`` alone,
    receive it on every call."""
    seen, calls = [], dict.fromkeys(("hcp_w", "hcpT_x", "precond_diag"), 0)
    for name in calls:
        fn = getattr(spmv, name)

        def checked(ops, *args, _fn=fn, _name=name, **kwargs):
            assert ops.b_cam is not None and ops.b_cam.shape == ops.b_rows.shape, _name
            seen.append(torch.equal(ops.b_cam, ops.b_rows[:, ops.cam_perm.long()]))
            calls[_name] += 1
            return _fn(ops, *args, **kwargs)

        monkeypatch.setattr(spmv, name, checked)
    sc = tsyn.make_scene(8, 200, noise_px=1.0, outlier_frac=0.1, outlier_px=60.0,
                         visibility=0.5, robust="cauchy", robust_scale=2.0,
                         perturb_rot=0.15, perturb_trans=0.3, perturb_point=0.3,
                         seed=3, dtype=np.float32, device="cpu")
    cmp = tcm.from_problem(sc.problem)
    cfg = LMConfig(max_iters=8, solver="pcg", cg_iters=10, cg_tol=1e-2, tol_grad=0.0,
                   tol_cost_rel=0.0, tol_step=0.0)
    solve(cmp, cfg, gops=make_grouped_ops(cmp))
    assert seen and all(seen) and all(calls.values())
    assert calls["precond_diag"] == cfg.max_iters


def test_cost_ticket_is_one_zero_counter_per_stream(monkeypatch):
    """The cost kernel's ticket: an int32 ``[1]`` zero, allocated once per
    (device, stream) and handed back on every later call (the kernel's last
    block resets it); two streams never share one."""
    monkeypatch.setattr(spmv, "_COST_TICKETS", {})
    cpu = torch.device("cpu")
    t = spmv.cost_ticket(cpu, 7)
    assert t.dtype == torch.int32 and t.shape == (1,) and t.device == cpu
    assert int(t.item()) == 0
    assert spmv.cost_ticket("cpu", 7) is t
    other = spmv.cost_ticket(cpu, 8)
    assert other is not t and int(other.item()) == 0
    assert set(spmv._COST_TICKETS) == {(cpu, 7), (cpu, 8)}


def test_plain_cost_allocates_no_ticket(monkeypatch):
    """On CPU tensors ``cost`` runs its plain version and leaves the ticket
    table untouched."""
    monkeypatch.setattr(spmv, "_COST_TICKETS", {})
    p = tsyn.make_bal_scene(5, 80, mean_track=3.0, max_track=5, robust="huber",
                            robust_scale=2.0, noise_px=1.0, seed=2, dtype=np.float32,
                            with_truth=False, layout="cm", device="cpu").problem
    ops = make_grouped_ops(p)
    got = spmv.cost(ops, tcm.cam_table(p), p.X3, p.robust_scale, model=p.camera_model,
                    robust=p.robust)
    ref = spmv.cost_plain(ops, tcm.cam_table(p), p.X3, p.robust_scale,
                          model=p.camera_model, robust=p.robust)
    assert torch.equal(got, ref) and spmv._COST_TICKETS == {}


@pytest.mark.parametrize("M", [1, 1023, 1024, 1025, 164_184, 4_999_244, 2**31 - 256])
def test_cost_partials_cover_one_block_per_sm(M):
    """The partials hold one double a block of 1024 observations, at most
    1024: more than the one block per SM (132 on an H100) the kernel runs,
    and never fewer than the blocks that M needs below that."""
    n = spmv.cost_blocks(M)
    assert 1 <= n <= 1024
    assert n == min(1024, -(-M // 1024))
