"""``pysfm_tpu_torch.examples.incremental_sfm`` against the JAX package's
``examples/incremental_sfm.py``, run itself (``runpy``) as the reference.

Under the tests JAX runs in f64 (x64 on), so the port runs in f64 on the
CPU, fed the minimal sets JAX draws (``JaxKeyChain``: torch cannot repeat
``jax.random``'s stream), and is held as ``test_run_incremental_matches_jax``
holds the pipeline: the same init pair, PnP inliers, registered frames and
triangulated points, poses and points within 1e-6 absolute (two LM solvers
summing in other orders over the BA solves), and the ATE within 1e-6.  The
f32 command (``--device cpu``, the port's own draws) must pass the
script's own gate and print ``OK``.
"""

import os
import pathlib
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_incremental import JaxKeyChain

from pysfm_tpu_torch.examples import incremental_sfm

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ref():
    return runpy.run_path(str(ROOT / "examples" / "incremental_sfm.py"))


def test_same_track_table_as_jax(ref):
    """The vectorised table equals the script's loop over the observations,
    bit for bit; against JAX's table, the visibility is equal and the
    measurements agree to the rounding of the two packages' projections."""
    uv, vis, intr, truth = incremental_sfm.track_table(np.float64)
    uv_loop = np.zeros_like(uv)
    vis_loop = np.zeros_like(vis)
    for m in range(truth.n_obs):
        f, tr = int(truth.obs_cam[m]), int(truth.obs_pt[m])
        uv_loop[f, tr] = truth.obs_uv[m].numpy()
        vis_loop[f, tr] = True
    np.testing.assert_array_equal(uv, uv_loop)
    np.testing.assert_array_equal(vis, vis_loop)
    np.testing.assert_array_equal(vis, ref["vis"])
    np.testing.assert_allclose(uv, ref["uv"], rtol=1e-12, atol=0)
    np.testing.assert_array_equal(intr, np.asarray(ref["truth"].intr))


def test_incremental_matches_jax_given_its_draws(ref):
    out = incremental_sfm.run(device="cpu", dtype=np.float64,
                              sampler=JaxKeyChain(incremental_sfm.SEED))
    rec, jrec = out["rec"], ref["rec"]
    assert rec.stats["init_pair"] == jrec.stats["init_pair"]
    assert rec.stats["pnp_inliers"] == jrec.stats["pnp_inliers"]
    np.testing.assert_array_equal(rec.registered, jrec.registered)
    np.testing.assert_array_equal(rec.has_point, jrec.has_point)
    assert out["n_points"] == int(jrec.has_point.sum())
    pj, pt = jrec.problem, rec.problem
    assert pt.R.dtype == torch.float64
    for name in ("R", "t", "X"):
        np.testing.assert_allclose(getattr(pt, name).numpy(), np.asarray(getattr(pj, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(out["ate"], ref["ate"], rtol=0, atol=1e-6)
    assert rec.registered.all() and out["ate"] < incremental_sfm.ATE_GATE


def test_incremental_command_prints_ok():
    r = subprocess.run([sys.executable, "-m", "pysfm_tpu_torch.examples.incremental_sfm",
                        "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
                       timeout=120, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().endswith("OK")
