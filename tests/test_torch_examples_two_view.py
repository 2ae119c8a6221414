"""``pysfm_tpu_torch.examples.two_view_ba`` against the JAX package's
``examples/two_view_ba.py``, run itself (``runpy``) as the reference.

Under the tests JAX runs in f64 (x64 on), so the port runs in f64 on the
CPU and is held to the dense route's tolerances of ``test_torch_lm.py``:
the cost log and damping within 1e-9 relative with identical accept
decisions and iteration counts, the points within 1e-7 relative (1e-9
absolute), and the RMSE within 1e-9 relative.  The f32 command
(``--device cpu``) must pass the script's own gate and print ``OK``.
"""

import os
import pathlib
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

from pysfm_tpu_torch.examples import two_view_ba

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ref():
    return runpy.run_path(str(ROOT / "examples" / "two_view_ba.py"))


def test_two_view_matches_jax_f64(ref):
    out = two_view_ba.run(device="cpu", dtype=np.float64)
    sj, st = ref["stats"], out["stats"]
    assert np.asarray(ref["solved"].X).dtype == np.float64
    assert out["n_iters"] == int(sj.n_iters)
    np.testing.assert_allclose(st.costs.numpy(), np.asarray(sj.costs), rtol=1e-9)
    np.testing.assert_array_equal(st.accepted.numpy(), np.asarray(sj.accepted))
    np.testing.assert_allclose(st.lams.numpy(), np.asarray(sj.lams), rtol=1e-9)
    np.testing.assert_allclose(out["solved"].X.numpy(), np.asarray(ref["solved"].X),
                               rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(out["rmse"], ref["rmse"], rtol=1e-9)
    assert out["rmse"] < 2.0 * two_view_ba.NOISE_PX


def test_two_view_command_prints_ok():
    r = subprocess.run([sys.executable, "-m", "pysfm_tpu_torch.examples.two_view_ba",
                        "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
                       timeout=120, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().endswith("OK")
