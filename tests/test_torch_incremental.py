"""The slice as a whole: the port's ``run_incremental`` against the JAX
package's on the case of ``test_pipeline.py`` (10 keyframes, 200 points,
0.5 px noise), in f64 on the CPU.

torch cannot reproduce ``jax.random``'s stream, so the port gets a sampler
that repeats the reference's key chain with ``jax.random`` (split once per
batched RANSAC, once per batch row, once per hypothesis, then
``jax.random.choice`` without replacement on ``w / sum(w)``): both sides
then fit the same minimal sets.  Decisions (init pair, registrations,
points, PnP inlier counts) must be identical; poses and points agree to
1e-6 (two LM solvers summing in other orders, over ~8 BA solves).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysfm_tpu.pipeline import IncrementalConfig as JConfig
from pysfm_tpu.pipeline import run_incremental as jrun
from pysfm_tpu.pipeline import synthetic as jsyn
from pysfm_tpu_torch.pipeline import IncrementalConfig, build_tracks, run_from_images, run_incremental
from pysfm_tpu_torch.utils import metrics

torch.set_num_threads(2)
SCENE = dict(noise_px=0.5, visibility=0.85, seed=13, radius=10.0)


class JaxKeyChain:
    """A port sampler that draws what the JAX pipeline draws: one split of
    the running key per call, one key per batch row, one per hypothesis."""

    def __init__(self, seed: int):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, weights, n_hypotheses, k):
        w = jnp.asarray(weights.cpu().numpy().astype(np.float64))
        self.key, sub = jax.random.split(self.key)
        keys = jax.random.split(sub, w.shape[0])
        return torch.as_tensor(np.array(_draw(keys, w, n_hypotheses, k)))


def _draw_row(key, w, n_hypotheses, k):
    def one(kh):
        return jax.random.choice(kh, w.shape[0], shape=(k,), replace=False,
                                 p=w / jnp.sum(w))

    return jax.vmap(one)(jax.random.split(key, n_hypotheses))


_draw = jax.jit(jax.vmap(_draw_row, in_axes=(0, 0, None, None)), static_argnums=(2, 3))


def tracks_from_scene(truth):
    """A synthetic scene's observations as a dense track table (f64)."""
    F, T = truth.n_cameras, truth.n_points
    oc, op = np.asarray(truth.obs_cam), np.asarray(truth.obs_pt)
    uv = np.zeros((F, T, 2))
    vis = np.zeros((F, T), bool)
    uv[oc, op] = np.asarray(truth.obs_uv)
    vis[oc, op] = True
    return uv, vis, np.asarray(truth.intr)


@pytest.fixture(scope="module")
def case():
    sc = jsyn.make_scene(10, 200, **SCENE)
    uv, vis, intr = tracks_from_scene(sc.truth)
    ref = jrun(uv, vis, intr, "pose", JConfig(seed=2))
    centers = np.asarray(sc.truth.R).transpose(0, 2, 1) @ -np.asarray(sc.truth.t)[..., None]
    return uv, vis, intr, ref, centers[..., 0]


def test_run_incremental_matches_jax(case):
    uv, vis, intr, ref, _ = case
    rec = run_incremental(uv, vis, intr, "pose", IncrementalConfig(seed=2),
                          device="cpu", sampler=JaxKeyChain(2))
    assert rec.stats["init_pair"] == ref.stats["init_pair"]
    assert rec.stats["pnp_inliers"] == ref.stats["pnp_inliers"]
    assert rec.stats["pnp_candidates"] == ref.stats["pnp_candidates"]
    assert rec.stats["filtered_obs"] == ref.stats["filtered_obs"]
    np.testing.assert_array_equal(rec.registered, ref.registered)
    np.testing.assert_array_equal(rec.has_point, ref.has_point)
    assert len(rec.stats["ba_costs"]) == len(ref.stats["ba_costs"])
    np.testing.assert_allclose(rec.stats["ba_costs"], ref.stats["ba_costs"], rtol=1e-9)
    pj, pt = ref.problem, rec.problem
    assert pt.R.dtype == torch.float64
    for name in ("R", "t", "X"):
        np.testing.assert_allclose(getattr(pt, name).numpy(), np.asarray(getattr(pj, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(pt.obs_w.numpy(), np.asarray(pj.obs_w))


def test_default_sampler_passes_the_reference_gates(case):
    """The port's own torch.Generator draws: the gates of
    ``test_pipeline.py::test_incremental_ten_keyframes`` at 0.5 px."""
    uv, vis, intr, _, centers = case
    rec = run_incremental(uv, vis, intr, "pose", IncrementalConfig(seed=2), device="cpu")
    assert rec.registered.all()
    assert rec.has_point.mean() > 0.9
    C_est = metrics.camera_centers(rec.problem.R, rec.problem.t)
    assert float(metrics.ate_rmse(C_est, torch.as_tensor(centers))) < 2e-2
    assert metrics.reprojection_rmse(rec.problem) < 1.0
    assert set(rec.stats["timings_s"]) == {
        "pnp", "triangulate", "window_ba", "hygiene", "bootstrap", "host_other"}


def test_register_batch_above_window_raises(case):
    uv, vis, intr, _, _ = case
    with pytest.raises(ValueError, match="register_batch"):
        run_incremental(uv, vis, intr, "pose", IncrementalConfig(register_batch=6, window=5),
                        device="cpu")


def test_pipeline_entry_points_default_to_the_card(case):
    """The card is the default device; without one the pipeline raises (it
    has no CPU fallback)."""
    for fn in (run_incremental, build_tracks, run_from_images):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if not torch.cuda.is_available():
        uv, vis, intr, _, _ = case
        with pytest.raises((RuntimeError, AssertionError)):
            run_incremental(uv, vis, intr, "pose", IncrementalConfig(seed=2))
