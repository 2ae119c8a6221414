"""Multi-process runs of the port (``pysfm_tpu_torch.dist.multihost`` and
``dist.launch``) against the JAX package's single-process solves, as
``tests/test_multihost.py`` holds the JAX package.

Two processes join only through torchrun's variables (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), each builds only its own
shard of the global partition, and both solve over gloo on the CPU; the
costs must reproduce the single-process solve within 1e-9 (dense) and
1e-8 (pcg, with and without the camera partition), the gates of
``tests/test_multihost.py``.  Every world has a collective timeout and a
wall timeout.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from pysfm_tpu.pipeline import synthetic as jsyn
from pysfm_tpu.problem import cm as jcm
from pysfm_tpu.solver import LMConfig as JLMConfig
from pysfm_tpu.solver import solve as jsolve
from pysfm_tpu_torch.dist import launch, multihost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT = 120
SCENE = dict(n_cameras=8, n_points=100, noise_px=0.4, visibility=0.8, seed=31)
DENSE = dict(max_iters=20)
PCG = dict(max_iters=10, tol_grad=0.0, tol_cost_rel=0.0, tol_step=0.0, solver="pcg",
           cg_iters=30, cg_tol=1e-10)

WORKER = '''
import sys
sys.path.insert(0, {root!r})
import numpy as np
import torch
from pysfm_tpu_torch import dist
from pysfm_tpu_torch.dist import multihost
from pysfm_tpu_torch.pipeline import synthetic
from pysfm_tpu_torch.problem import cm
from pysfm_tpu_torch.solver import LMConfig

torch.set_num_threads(1)
multihost.initialize(device="cpu", timeout={timeout})   # from the environment
mesh = multihost.global_mesh(device="cpu")
assert mesh.size == 2
p = synthetic.make_scene(**{scene!r}, device="cpu").problem
sp = multihost.shard_problem_multihost(p, mesh)
assert sp.n_shards == 1
_, st = dist.solve_sharded(sp, mesh, LMConfig(**{dense!r}))
scm, gops = multihost.shard_cm_problem_multihost(cm.from_problem(p), mesh, with_grouped=False)
assert gops is None
_, st_cm = dist.solve_sharded_cm(scm, None, mesh, LMConfig(**{pcg!r}))
_, st_cam = dist.solve_sharded_cm(scm, None, mesh, LMConfig(**{pcg!r}), cam_axis=True)
assert "jax" not in sys.modules
np.savez(sys.argv[1] + ".%d.npz" % mesh.rank, dense=st.costs.numpy(), cm=st_cm.costs.numpy(),
         cam=st_cam.costs.numpy())
multihost.shutdown()
'''


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("multihost")
    script = d / "worker.py"
    script.write_text(WORKER.format(root=ROOT, scene=SCENE, dense=DENSE, pcg=PCG,
                                    timeout=WORLD_TIMEOUT))
    launch.run_script(str(script), 2, (d / "w",), timeout=WORLD_TIMEOUT)
    return [dict(np.load(d / f"w.{r}.npz")) for r in range(2)]


@pytest.fixture(scope="module")
def jax_refs():
    p = jsyn.make_scene(**SCENE).problem
    _, st = jsolve(p, JLMConfig(**DENSE))
    _, st_cm = jsolve(jcm.from_problem(p), JLMConfig(**PCG))
    return {"dense": np.asarray(st.costs), "cm": np.asarray(st_cm.costs),
            "cam": np.asarray(st_cm.costs)}


@pytest.mark.parametrize("run,rtol", [("dense", 1e-9), ("cm", 1e-8), ("cam", 1e-8)])
def test_two_process_solve_matches_single(two_ranks, jax_refs, run, rtol):
    for out in two_ranks:
        np.testing.assert_allclose(out[run], jax_refs[run], rtol=rtol)


@pytest.mark.parametrize("env,args", [
    (dict(MASTER_ADDR="127.0.0.1", MASTER_PORT="1"), {}),
    (dict(MASTER_ADDR="127.0.0.1"), dict(num_processes=2, process_id=0)),
    ({}, dict(coordinator_address="127.0.0.1:1", process_id=0)),
])
def test_initialize_rejects_partial_config(monkeypatch, env, args):
    """A half-configured launch fails loudly instead of running each
    process as a world of its own."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="partial multi-host"):
        multihost.initialize(device="cpu", **args)


HANG = '''
import os, sys, time
sys.path.insert(0, {root!r})
import torch
import torch.distributed as tdist
from pysfm_tpu_torch.dist import multihost

multihost.initialize(device="cpu", timeout=5)
x = torch.ones(3)
if tdist.get_rank() == 0:
    tdist.all_reduce(x)     # rank 1 never joins this collective
else:
    time.sleep(8)           # alive, but elsewhere, past rank 0's timeout
'''


def test_rank_out_of_step_fails_within_timeout(tmp_path):
    """A rank that skips a collective (a decision taken on a local value)
    fails the world at the collective timeout instead of hanging it."""
    script = tmp_path / "hang.py"
    script.write_text(HANG.format(root=ROOT))
    with pytest.raises((RuntimeError, TimeoutError)):
        launch.run_script(str(script), 2, timeout=60)


def test_distributed_example_runs():
    """``python -m pysfm_tpu_torch.examples.distributed_ba``: two ranks over
    gloo, its own criterion (deviation from the single-device trajectory
    below 1e-4)."""
    r = subprocess.run(
        [sys.executable, "-m", "pysfm_tpu_torch.examples.distributed_ba", "--nproc", "2",
         "--device", "cpu", "--timeout", str(WORLD_TIMEOUT)],
        cwd=ROOT, capture_output=True, text=True, timeout=WORLD_TIMEOUT + 30,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().endswith("OK")
