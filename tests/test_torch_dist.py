"""The port's point-sharded partition and distributed dense / pcg LM
(``pysfm_tpu_torch.dist``: ``shard``, ``sharded_lm``) against the JAX
package.

The port's ranks are separate processes over gloo on the CPU, joined
through torchrun's variables (``dist.launch.run_script``).  They import no
JAX: the worker below is a script of its own.  Each world (2 and 4 ranks)
starts once per module, runs every configuration and writes one npz per
rank; the tests compare those with the JAX package's single-device solves,
which its own tests (``tests/test_dist.py``) hold equal to its sharded
ones.

Tolerances: the partition arrays exactly; cost logs within 1e-9 relative
and equal iteration counts on the dense routes, 1e-7 on the pcg route (as
``tests/test_dist.py``; the two sum in other orders); the ranks' logs
bitwise equal to each other (every rank reads the same reduced values).
"""

import os

import numpy as np
import pytest
import torch

from pysfm_tpu import dist as jdist
from pysfm_tpu.pipeline import synthetic as jsyn
from pysfm_tpu.problem import cm as jcm
from pysfm_tpu.solver import LMConfig as JLMConfig
from pysfm_tpu.solver import solve as jsolve
from pysfm_tpu_torch import dist
from pysfm_tpu_torch.dist import launch
from pysfm_tpu_torch.pipeline import synthetic as tsyn
from pysfm_tpu_torch.problem import cm as tcm

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Seconds a world may take, start-up included; a hang fails one test.
WORLD_TIMEOUT = 120

# name: (make_scene arguments, LMConfig arguments), as tests/test_dist.py.
CONFIGS = {
    "dense": (dict(n_cameras=8, n_points=100, noise_px=0.4, visibility=0.8, seed=31),
              dict(max_iters=20)),
    "std": (dict(n_cameras=8, n_points=100, noise_px=0.4, visibility=0.8, seed=31),
            dict(max_iters=20, layout="std")),
    "huber": (dict(n_cameras=6, n_points=64, noise_px=0.3, outlier_frac=0.1,
                   robust="huber", robust_scale=2.0, seed=32), dict(max_iters=15)),
    "pcg": (dict(n_cameras=10, n_points=120, noise_px=0.4, visibility=0.7,
                 robust="huber", robust_scale=2.0, seed=35),
            dict(max_iters=15, solver="pcg", cg_tol=1e-10, cg_iters=300, obs_chunk=128)),
    "uneven": (dict(n_cameras=4, n_points=101, noise_px=0.2, seed=33), dict(max_iters=10)),
}
RTOL = {"pcg": 1e-7}

WORKER = '''
import sys
sys.path.insert(0, {root!r})
import numpy as np
import torch
from pysfm_tpu_torch import dist
from pysfm_tpu_torch.dist import multihost
from pysfm_tpu_torch.pipeline import synthetic
from pysfm_tpu_torch.problem import problem as problem_mod
from pysfm_tpu_torch.solver import LMConfig

torch.set_num_threads(1)
multihost.initialize(device="cpu", timeout={timeout})
mesh = multihost.global_mesh(device="cpu")
out = {{}}
for name, (scene, cfg) in {configs!r}.items():
    p = synthetic.make_scene(**scene, device="cpu").problem
    sp = dist.device_put_sharded(dist.shard_problem(p, mesh.size), mesh)
    solved, st = dist.solve_sharded(sp, mesh, LMConfig(**cfg))
    pb = dist.unshard_problem(solved, p, mesh)
    out[name + "/costs"] = st.costs.numpy()
    out[name + "/n_iters"] = st.n_iters.numpy()
    out[name + "/X"] = pb.X.numpy()
    out[name + "/cost_unsharded"] = problem_mod.cost(pb).numpy()
assert "jax" not in sys.modules
np.savez(sys.argv[1] + ".%d.npz" % mesh.rank, **out)
multihost.shutdown()
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{n: [each rank's outputs]} of the worker over 2 and 4 ranks."""
    d = tmp_path_factory.mktemp("dist")
    script = d / "worker.py"
    script.write_text(WORKER.format(root=ROOT, configs=CONFIGS, timeout=WORLD_TIMEOUT))
    out = {}
    for n in (2, 4):
        launch.run_script(str(script), n, (d / f"w{n}",), timeout=WORLD_TIMEOUT)
        out[n] = [dict(np.load(d / f"w{n}.{r}.npz")) for r in range(n)]
    return out


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's single-device solve of every configuration."""
    refs = {}
    for name, (scene, cfg) in CONFIGS.items():
        p = jsyn.make_scene(**scene).problem
        cfg = dict(cfg, obs_chunk=0) if "obs_chunk" in cfg else cfg
        solved, st = jsolve(p, JLMConfig(**cfg))
        refs[name] = (np.asarray(st.costs), int(st.n_iters), np.asarray(solved.X))
    return refs


def _port_problem(p):
    from pysfm_tpu_torch.problem import problem as tprob

    return tprob.from_numpy({k: np.asarray(getattr(p, k)) for k in tprob.FIELDS},
                            p.camera_model, p.robust, device="cpu")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_solve_sharded_matches_jax(ranks, jax_refs, n, name):
    costs, n_iters, X = jax_refs[name]
    rtol = RTOL.get(name, 1e-9)
    out = ranks[n]
    np.testing.assert_allclose(out[0][name + "/costs"], costs, rtol=rtol)
    assert int(out[0][name + "/n_iters"]) == n_iters
    for r in range(1, n):
        np.testing.assert_array_equal(out[r][name + "/costs"], out[0][name + "/costs"])
    # The gathered problem evaluates to the log's last cost, and its points
    # are the single-device solve's.
    np.testing.assert_allclose(out[0][name + "/cost_unsharded"], out[0][name + "/costs"][-1],
                               rtol=rtol)
    np.testing.assert_allclose(out[0][name + "/X"], X, atol=1e-8 if rtol == 1e-9 else 1e-6)


PARTITIONS = {
    "2": (dict(n_cameras=8, n_points=100, noise_px=0.4, visibility=0.8, seed=31), 2),
    "4": (dict(n_cameras=8, n_points=100, noise_px=0.4, visibility=0.8, seed=31), 4),
    "uneven": (dict(n_cameras=4, n_points=101, noise_px=0.2, seed=33), 4),
}


@pytest.mark.parametrize("case", list(PARTITIONS))
def test_shard_problem_equals_jax(case):
    scene, n = PARTITIONS[case]
    jp = jsyn.make_scene(**scene).problem
    js = jdist.shard_problem(jp, n)
    ts = dist.shard_problem(_port_problem(jp), n)
    for f in dist.shard.SHARDED_FIELDS + dist.shard.REPL_FIELDS:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    # One shard built alone is that shard of the stacked partition.
    one = dist.shard_problem(_port_problem(jp), n, shards=[n - 1])
    for f in dist.shard.SHARDED_FIELDS:
        assert torch.equal(getattr(one, f)[0], getattr(ts, f)[n - 1]), f


@pytest.mark.parametrize("case", list(PARTITIONS))
def test_shard_cm_problem_equals_jax(case):
    scene, n = PARTITIONS[case]
    jp = jcm.from_problem(jsyn.make_scene(**scene).problem)
    js, _ = jdist.shard_cm_problem(jp, n, with_grouped=False)
    tp = tcm.from_numpy({k: np.asarray(getattr(jp, k)) for k in tcm.FIELDS},
                        jp.camera_model, jp.robust, device="cpu")
    ts = dist.shard_cm_problem(tp, n)
    for f in dist.sharded_cm.SHARDED_FIELDS + dist.sharded_cm.REPL_FIELDS:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


def test_shard_problem_roundtrip():
    """As tests/test_dist.py: the gathered points are the problem's, and
    every observation is in exactly one shard."""
    p = tsyn.make_scene(3, 37, noise_px=0.1, seed=34, device="cpu").problem
    sp = dist.shard_problem(p, 4)
    assert torch.equal(dist.unshard_points(sp), p.X)
    assert int((sp.obs_w > 0).sum()) == p.n_obs
    scm = dist.shard_cm_problem(tcm.from_problem(p), 4)
    assert torch.equal(dist.unshard_cm(scm, tcm.from_problem(p)).X3, p.X.T)

