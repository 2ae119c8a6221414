"""The port's distributed pcg route (``dist.sharded_cm``: the
component-major LM loop over a process group, the camera-axis partition of
the reduced solve, the kernel operands on each rank's shard) and its
sharded checkpoints, against the JAX package.

Ranks are processes over gloo on the CPU (``dist.launch.run_script``),
importing no JAX; each world (2 and 4 ranks) starts once per module and
runs every configuration.  On the CPU the kernel wrappers take their plain
versions, so the ``sgops`` configurations run the kernels' plain twins on
each rank's own operands.

Tolerances, those of ``tests/test_sharded_cm.py``: f64 cost logs within
1e-9 relative and CG iteration counts equal; X3 within rtol 1e-6 / atol
1e-9 and R within rtol 1e-7 / atol 1e-10; f32 with kernel operands within
1e-3 of the JAX f32 solve, X3 within rtol 2e-2 / atol 2e-3; a resumed
solve continues the uninterrupted one within 1e-9 (``tests/test_io.py``,
CG at 1e-10 so the lost warm start does not show); checkpoints exact.
"""

import os

import numpy as np
import pytest
import torch

from pysfm_tpu import dist as jdist
from pysfm_tpu.io import load_checkpoint_sharded_cm as jload_cm
from pysfm_tpu.io import save_checkpoint_sharded_cm as jsave_cm
from pysfm_tpu.pipeline import synthetic as jsyn
from pysfm_tpu.solver import LMConfig as JLMConfig
from pysfm_tpu.solver import solve as jsolve
from pysfm_tpu_torch import dist
from pysfm_tpu_torch.dist import launch
from pysfm_tpu_torch.io import (
    load_checkpoint_sharded, load_checkpoint_sharded_cm, save_checkpoint_sharded,
)
from pysfm_tpu_torch.problem import cm as tcm

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT = 120

SCENES = {
    "bal3": dict(n_cameras=8, n_points=500, seed=3),
    # C = 6 over 4 ranks: two pad rows in the camera partition.
    "bal11": dict(n_cameras=6, n_points=320, seed=11),
    # tests/test_io.py's sharded CM checkpoint scene.
    "bal9": dict(n_cameras=6, n_points=320, seed=9),
}
BAL = dict(mean_track=4.0, max_track=8, noise_px=0.5, with_truth=False, layout="cm")
BASE = dict(tol_grad=0.0, tol_cost_rel=0.0, tol_step=0.0, solver="pcg", cg_iters=20,
            cg_tol=1e-8)
CFG4 = dict(BASE, max_iters=4)
EW = dict(BASE, max_iters=5, cg_forcing="ew", cg_q_tol=0.1, cg_tol=1e-6)
K3 = dict(BASE, max_iters=3, cg_tol=1e-6)
CKPT = dict(BASE, max_iters=8, cg_tol=1e-10)
# name: (scene, dtype, LMConfig arguments, cam_axis, kernel operands, worlds)
CONFIGS = {
    "plain": ("bal3", "float64", CFG4, False, False, (2, 4)),
    "cam": ("bal3", "float64", CFG4, True, False, (2, 4)),
    "ew": ("bal3", "float64", EW, False, False, (2, 4)),
    "warm": ("bal11", "float64", CFG4, False, False, (2,)),
    "warm_cam": ("bal11", "float64", CFG4, True, False, (2, 4)),
    "kernels": ("bal3", "float32", K3, False, True, (4,)),
    "kernels_cam": ("bal3", "float32", K3, True, True, (4,)),
}

WORKER = '''
import dataclasses, sys
sys.path.insert(0, {root!r})
import numpy as np
import torch
import torch.distributed as tdist
from pysfm_tpu_torch import dist
from pysfm_tpu_torch.dist import multihost
from pysfm_tpu_torch.io import load_checkpoint_sharded_cm, save_checkpoint_sharded_cm
from pysfm_tpu_torch.pipeline import synthetic
from pysfm_tpu_torch.solver import LMConfig, pcg, scale, schur

torch.set_num_threads(1)
multihost.initialize(device="cpu", timeout={timeout})
mesh = multihost.global_mesh(device="cpu")
prefix = sys.argv[1]
out = {{}}

def scene(name, dtype):
    return synthetic.make_bal_scene(**{scenes!r}[name], **{bal!r}, dtype=getattr(np, dtype),
                                    device="cpu").problem

for name, (sc, dtype, cfg, cam_axis, kernels, worlds) in {configs!r}.items():
    if mesh.size not in worlds:
        continue
    cmp = scene(sc, dtype)
    local, gops = dist.device_put_sharded_cm(dist.shard_cm_problem(cmp, mesh.size), mesh,
                                             with_grouped=kernels)
    solved, st = dist.solve_sharded_cm(local, gops, mesh, LMConfig(**cfg), cam_axis=cam_axis)
    merged = dist.unshard_cm(solved, cmp, mesh)
    for f in ("costs", "cg_iters", "accepted"):
        out[name + "/" + f] = getattr(st, f).numpy()
    out[name + "/X3"] = merged.X3.numpy()
    out[name + "/R"] = merged.R.numpy()

# The camera partition's pad rows (C = 6 over 4 ranks): zero rhs, identity
# blocks.
cmp = scene("bal11", "float64")
local, _ = dist.device_put_sharded_cm(dist.shard_cm_problem(cmp, mesh.size), mesh,
                                      with_grouped=False)
lp = dist.sharded_cm._local_cm(local)
eqs = schur.sum_cameras(scale.build_normal_equations_scale_cm(lp), mesh)
cam = pcg.make_cam_shard(mesh, cmp.n_cameras, mesh.size)
sys_ = pcg.build_pcg_system(eqs, torch.tensor(1e-3, dtype=torch.float64), lp.obs_cam,
                            lp.obs_pt, lp.pt_obsT, lp.pt_obs_maskT, lp.cam_obs,
                            lp.cam_obs_mask, group=mesh, cam=cam)
out["cam/rhs"], out["cam/M_inv"], out["cam/Hcc_aug"] = (
    sys_.rhs.numpy(), sys_.M_inv.numpy(), sys_.Hcc_aug.numpy())

if mesh.size == 2:
    cmp = scene("bal3", "float64")
    local, _ = dist.device_put_sharded_cm(dist.shard_cm_problem(cmp, 2), mesh, with_grouped=False)
    # Each rank writes its part of the unsolved partition (read by JAX).
    save_checkpoint_sharded_cm(prefix + ".ckpt0.npz", local, lam=0.5, nu=4.0, iteration=7,
                               mesh=mesh)
    cfg = LMConfig(**{ckpt!r})
    cmp = scene("bal9", "float64")
    local, _ = dist.device_put_sharded_cm(dist.shard_cm_problem(cmp, 2), mesh, with_grouped=False)
    _, st_full = dist.solve_sharded_cm(local, None, mesh, cfg)
    half_cfg = dataclasses.replace(cfg, max_iters=cfg.max_iters // 2)
    half, st_half = dist.solve_sharded_cm(local, None, mesh, half_cfg)
    path = prefix + ".ckpt.npz"
    save_checkpoint_sharded_cm(path, half, lam=float(st_half.lam_next),
                               nu=float(st_half.nu_next), iteration=half_cfg.max_iters,
                               mesh=mesh)
    tdist.barrier()
    scm_r, lam_r, nu_r, it_r = load_checkpoint_sharded_cm(path)
    assert it_r == half_cfg.max_iters
    assert torch.equal(scm_r.X3[mesh.rank], half.X3[0])
    local_r, _ = dist.device_put_sharded_cm(scm_r, mesh, with_grouped=False)
    _, st_res = dist.solve_sharded_cm(local_r, None, mesh, half_cfg, lam_init=lam_r,
                                      nu_init=nu_r)
    out["ckpt/full"], out["ckpt/resumed"] = st_full.costs.numpy(), st_res.costs.numpy()
assert "jax" not in sys.modules
np.savez(prefix + ".%d.npz" % mesh.rank, **out)
multihost.shutdown()
'''


def _jscene(name, dtype):
    return jsyn.make_bal_scene(**SCENES[name], **BAL, dtype=getattr(np, dtype)).problem


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{n: [each rank's outputs]} over 2 and 4 ranks, and the file prefix."""
    d = tmp_path_factory.mktemp("sharded_cm")
    script = d / "worker.py"
    script.write_text(WORKER.format(root=ROOT, configs=CONFIGS, scenes=SCENES, bal=BAL,
                                    ckpt=CKPT, timeout=WORLD_TIMEOUT))
    out = {}
    for n in (2, 4):
        launch.run_script(str(script), n, (d / f"w{n}",), timeout=WORLD_TIMEOUT)
        out[n] = [dict(np.load(d / f"w{n}.{r}.npz")) for r in range(n)]
    return out, d


@pytest.fixture(scope="module")
def jax_refs():
    """JAX single-device solves per configuration (cam_axis is a
    distributed option only), and JAX's own sharded solve over 2 devices."""
    refs, cache = {}, {}
    for name, (sc, dtype, cfg, _, _, _) in CONFIGS.items():
        key = (sc, dtype, tuple(sorted(cfg.items())))
        if key not in cache:
            solved, st = jsolve(_jscene(sc, dtype), JLMConfig(**cfg))
            cache[key] = (np.asarray(st.costs), np.asarray(st.cg_iters),
                          np.asarray(solved.X3), np.asarray(solved.R))
        refs[name] = cache[key]
    cmp = _jscene("bal3", "float64")
    mesh = jdist.make_mesh(2)
    scm, _ = jdist.shard_cm_problem(cmp, 2, with_grouped=False)
    scm, _ = jdist.device_put_sharded_cm(scm, None, mesh)
    out, st = jdist.solve_sharded_cm(scm, None, mesh, JLMConfig(**CFG4))
    refs["jax_sharded"] = (np.asarray(st.costs), np.asarray(st.cg_iters),
                           np.asarray(jdist.unshard_cm(out, cmp).X3))
    return refs


CASES = [(name, n) for name, c in CONFIGS.items() for n in c[5]]


@pytest.mark.parametrize("name,n", CASES)
def test_solve_sharded_cm_matches_jax(ranks, jax_refs, name, n):
    out = ranks[0][n]
    costs, cg, X3, R = jax_refs[name]
    got = out[0]
    for r in range(1, n):
        np.testing.assert_array_equal(out[r][name + "/costs"], got[name + "/costs"])
        np.testing.assert_array_equal(out[r][name + "/X3"], got[name + "/X3"])
    if CONFIGS[name][4]:   # f32, kernel operands (their plain versions here)
        np.testing.assert_allclose(got[name + "/costs"], costs, rtol=1e-3)
        np.testing.assert_allclose(got[name + "/X3"], X3, rtol=2e-2, atol=2e-3)
        return
    np.testing.assert_allclose(got[name + "/costs"], costs, rtol=1e-9)
    np.testing.assert_array_equal(got[name + "/cg_iters"], cg)
    np.testing.assert_allclose(got[name + "/X3"], X3, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got[name + "/R"], R, rtol=1e-7, atol=1e-10)


def test_two_ranks_match_jax_sharded_solve(ranks, jax_refs):
    """Held against JAX's solve_sharded_cm itself (a mesh of 2)."""
    costs, cg, X3 = jax_refs["jax_sharded"]
    got = ranks[0][2][0]
    np.testing.assert_allclose(got["plain/costs"], costs, rtol=1e-9)
    np.testing.assert_array_equal(got["plain/cg_iters"], cg)
    np.testing.assert_allclose(got["plain/X3"], X3, rtol=1e-6, atol=1e-9)


def test_camera_partition_pad_rows(ranks):
    """C = 6 over 4 ranks: rank 3 owns rows 6, 7, both padding; their rhs
    is zero and their blocks are the identity, so CG keeps them zero."""
    out = ranks[0][4]
    for r in range(4):
        assert out[r]["cam/rhs"].shape == (6, 2)
    last = out[3]
    np.testing.assert_array_equal(last["cam/rhs"], 0.0)
    np.testing.assert_array_equal(last["cam/M_inv"], np.broadcast_to(np.eye(6), (2, 6, 6)))
    np.testing.assert_array_equal(last["cam/Hcc_aug"], np.broadcast_to(np.eye(6), (2, 6, 6)))


def test_resumed_solve_continues(ranks):
    got = ranks[0][2][0]
    half = CKPT["max_iters"] // 2
    np.testing.assert_allclose(got["ckpt/resumed"][1:], got["ckpt/full"][half + 1:], rtol=1e-9)


def test_port_checkpoint_loads_in_jax(ranks):
    """Parts written by the port's two ranks reassemble in the JAX package
    to the partition they were written from."""
    from pysfm_tpu_torch.pipeline import synthetic as tsyn

    _, d = ranks
    scm, lam, nu, it = jload_cm(str(d / "w2.ckpt0.npz"))
    tp = tsyn.make_bal_scene(**SCENES["bal3"], **BAL, dtype=np.float64, device="cpu").problem
    ref = dist.shard_cm_problem(tp, 2)
    assert (lam, nu, it) == (0.5, 4.0, 7)
    for f in dist.sharded_cm.SHARDED_FIELDS + dist.sharded_cm.REPL_FIELDS:
        a, b = np.asarray(getattr(scm, f)), getattr(ref, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_jax_checkpoint_loads_in_port(tmp_path):
    """A checkpoint JAX writes on a mesh of 2 loads in the port with its
    arrays equal to the port's own partition."""
    cmp = _jscene("bal3", "float64")
    mesh = jdist.make_mesh(2)
    scm, _ = jdist.shard_cm_problem(cmp, 2, with_grouped=False)
    scm, _ = jdist.device_put_sharded_cm(scm, None, mesh)
    path = str(tmp_path / "jax_ckpt.npz")
    jsave_cm(path, scm, lam=0.25, nu=8.0, iteration=3)
    got, lam, nu, it = load_checkpoint_sharded_cm(path)
    tp = tcm.from_numpy({k: np.asarray(getattr(cmp, k)) for k in tcm.FIELDS},
                        cmp.camera_model, cmp.robust, device="cpu")
    ref = dist.shard_cm_problem(tp, 2)
    assert (lam, nu, it) == (0.25, 8.0, 3)
    for f in dist.sharded_cm.SHARDED_FIELDS + dist.sharded_cm.REPL_FIELDS:
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f


def test_sharded_checkpoint_std_roundtrip_and_torn_part(tmp_path):
    """The standard-layout sharded checkpoint: the port's stacked partition
    round-trips through JAX's loader; a part that leaves shard rows
    uncovered makes the port's loader raise."""
    from pysfm_tpu.io import load_checkpoint_sharded as jload

    p = jsyn.make_scene(6, 90, noise_px=0.3, seed=9).problem
    from pysfm_tpu_torch.problem import problem as tprob

    tp = tprob.from_numpy({k: np.asarray(getattr(p, k)) for k in tprob.FIELDS},
                          p.camera_model, p.robust, device="cpu")
    sp = dist.shard_problem(tp, 3)
    path = str(tmp_path / "std.npz")
    part = save_checkpoint_sharded(path, sp, lam=1e-2, iteration=5)
    js, lam, _, it = jload(path)
    assert (lam, it) == (1e-2, 5)
    for f in dist.shard.SHARDED_FIELDS + dist.shard.REPL_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(js, f)), getattr(sp, f).numpy(),
                                      err_msg=f)
    back, _, _, _ = load_checkpoint_sharded(path)
    assert torch.equal(back.X, sp.X)
    z = dict(np.load(part))
    z["shard_sizes"] = z["shard_sizes"] - 1
    with open(part + ".fix", "wb") as f:
        np.savez(f, **z)
    os.replace(part + ".fix", part)
    with pytest.raises(ValueError, match="incomplete"):
        load_checkpoint_sharded(path)
