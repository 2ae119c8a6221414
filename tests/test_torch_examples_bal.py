"""``pysfm_tpu_torch.examples.bal_checkpoint_resume`` against the JAX
package's ``examples/bal_checkpoint_resume.py``, run itself (``runpy``) as
the reference.

Both run in f32 (the script asks for it).  On the JAX script's literal
route (``grouped=False``) the resumed and the uninterrupted final costs are
within 1e-6 relative of JAX's; with the pcg kernels' operands
(``grouped=True``, their plain versions on the CPU) within 1e-3, the f32
tolerance of ``test_torch_pcg_lm.py``, and each kernel wrapper is called
as often as ``chip_smoke.py`` requires on the card from the three solves'
LM/CG logs.  The command (``--device cpu``) must pass the script's own gate
and print ``OK``.
"""

import collections
import os
import pathlib
import runpy
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from pysfm_tpu_torch.examples import bal_checkpoint_resume
from pysfm_tpu_torch.solver.kernels import spmv

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ref():
    g = runpy.run_path(str(ROOT / "examples" / "bal_checkpoint_resume.py"))
    shutil.rmtree(g["tmp"], ignore_errors=True)
    assert np.asarray(g["prob"].X).dtype == np.float32
    return g


def _costs(out):
    return [out["cost0"], out["c_resumed"], out["c_full"]]


def _ref_costs(ref):
    return [float(ref["st"].costs[0]), ref["c_resumed"], ref["c_full"]]


def test_literal_route_matches_jax_f32(ref):
    out = bal_checkpoint_resume.run(device="cpu", grouped=False)
    assert not out["grouped"]
    assert (out["n_cameras"], out["n_points"], out["n_obs"]) == (
        ref["prob"].n_cameras, ref["prob"].n_points, ref["prob"].n_obs)
    assert out["iteration"] == int(ref["it"]) == bal_checkpoint_resume.HALF
    np.testing.assert_allclose(_costs(out), _ref_costs(ref), rtol=1e-6)
    c_res, c_full = out["c_resumed"], out["c_full"]
    assert abs(c_res - c_full) <= bal_checkpoint_resume.RTOL * abs(c_full)


def test_kernel_operands_match_jax_f32(ref, monkeypatch):
    import chip_smoke

    calls = collections.Counter()
    for name in chip_smoke.SPMV_KERNELS:
        fn = getattr(spmv, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(spmv, name, counted)
    out = bal_checkpoint_resume.run(device="cpu", grouped=True)
    assert out["grouped"]
    assert dict(calls) == {k: v for k, v in chip_smoke._expected_bal_example(out).items() if v}
    np.testing.assert_allclose(_costs(out), _ref_costs(ref), rtol=1e-3)
    c_res, c_full = out["c_resumed"], out["c_full"]
    assert abs(c_res - c_full) <= bal_checkpoint_resume.RTOL * abs(c_full)


def test_bal_command_prints_ok():
    r = subprocess.run([sys.executable, "-m", "pysfm_tpu_torch.examples.bal_checkpoint_resume",
                        "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
                       timeout=120, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().endswith("OK")
