"""``utils/trace.py`` (over ``torch.profiler``) and ``io/viz.py`` of the
port, against the JAX package's modules.

The trace must be a file that names an ``annotate`` region; viz's camera
centres and frustum corners must equal the JAX package's within 1e-12 in
f64 (the same NumPy arithmetic on the same inputs); the three draw
functions must write files through matplotlib's Agg backend, as
``tests/test_io.py::test_viz_smoke`` does for the JAX package.
"""

import glob
import json

import numpy as np
import pytest
import torch

from pysfm_tpu.io import viz as jviz
from pysfm_tpu.pipeline import synthetic as jsyn
from pysfm_tpu_torch.io import viz
from pysfm_tpu_torch.pipeline import synthetic as tsyn
from pysfm_tpu_torch.solver import LMConfig, solve
from pysfm_tpu_torch.utils import trace

torch.set_num_threads(2)


def test_trace_capture_names_regions(tmp_path):
    p = tsyn.make_scene(4, 60, noise_px=0.3, seed=3, device="cpu").problem
    d = str(tmp_path / "trace")
    with trace.capture(d):
        with trace.annotate("solve_region"):
            solve(p, LMConfig(max_iters=2))
        trace.annotate_fn(lambda: torch.ones(3), "fn_region")()
    files = glob.glob(d + "/*.json")
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"solve_region", "fn_region"} <= names


@pytest.mark.parametrize("model", ["pose", "bal"])
def test_frustum_geometry_matches_jax(model):
    if model == "bal":
        kw = dict(camera_model="bal", seed=2, with_truth=False, dtype=np.float64)
        jp = jsyn.make_bal_scene(5, 40, **kw).problem
        tp = tsyn.make_bal_scene(5, 40, **kw, device="cpu").problem
    else:
        jp = jsyn.make_scene(5, 40, seed=2, dtype=np.float64).problem
        tp = tsyn.make_scene(5, 40, seed=2, dtype=np.float64, device="cpu").problem
    R, t, intr = (np.asarray(getattr(jp, f), np.float64) for f in ("R", "t", "intr"))
    jc, jw = jviz._frustum_corners(R, t, intr, model, 0.5)
    # The port's own problem (tensors) and the JAX problem's arrays.
    for args in ((tp.R, tp.t, tp.intr), (R, t, intr)):
        tc, tw = viz._frustum_corners(*args, model, 0.5)
        np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-12)
        np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-12)
    np.testing.assert_allclose(viz._camera_centers(tp.R, tp.t), jviz._camera_centers(R, t),
                               rtol=0, atol=1e-12)


def test_draw_functions_write_files(tmp_path):
    p = tsyn.make_bal_scene(6, 200, camera_model="bal", seed=1, with_truth=False,
                            device="cpu").problem
    viz.draw_bundle(p, str(tmp_path / "bundle.png"))
    viz.draw_reprojections(p, 0, str(tmp_path / "reproj.png"))
    _, stats = solve(p, LMConfig(max_iters=3))
    viz.plot_convergence(stats, str(tmp_path / "conv.png"))
    for name in ("bundle.png", "reproj.png", "conv.png"):
        assert (tmp_path / name).stat().st_size > 0
