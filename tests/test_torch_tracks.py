"""Images -> tracks -> incremental SfM on the port, held to the JAX
package's ``build_tracks`` and to ``test_tracks.py``'s gates, on the CPU.

The dot video is ``chip_smoke.dot_video`` (the vectorised copy of
``test_tracks.py``'s renderer that the chip run uses), checked bit for bit
against the reference renderer first.  ``build_tracks`` runs on the first
3 frames with 128 keypoints; the port gets a sampler that repeats the JAX
key chain (one split per verified pair), so both sides verify each pair on
the same minimal sets: the same track table, uv within 1e-9.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import test_tracks
from pysfm_tpu.pipeline import TrackingConfig as JTrackingConfig
from pysfm_tpu.pipeline import build_tracks as jbuild_tracks
from pysfm_tpu_torch.pipeline import IncrementalConfig, TrackingConfig, build_tracks, run_from_images
from pysfm_tpu_torch.utils import metrics
from test_torch_frontend import jax_draws

torch.set_num_threads(2)


class JaxTrackKeys:
    """A port sampler that draws what the JAX ``build_tracks`` draws: one
    split of the running key per verified pair, then the RANSAC's own
    draws from the subkey."""

    def __init__(self, seed: int):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, weights, n_hypotheses, k):
        self.key, sub = jax.random.split(self.key)
        w = np.asarray(weights[0].cpu().numpy(), np.float64)
        return torch.as_tensor(np.array(jax_draws(sub, w, n_hypotheses, k)))[None]


@pytest.fixture(scope="module")
def video():
    return chip_smoke.dot_video()


def test_dot_video_is_the_reference_video(video):
    images, centers, X, textures = video
    assert images.shape == (6, test_tracks.H, test_tracks.W)
    for img, c in zip(images, centers):
        p = X - c
        px = np.stack([test_tracks.FX * p[:, 0] / p[:, 2] + test_tracks.CX,
                       test_tracks.FY * p[:, 1] / p[:, 2] + test_tracks.CY], axis=-1)
        np.testing.assert_array_equal(img, test_tracks._render(px, textures))


def test_build_tracks_matches_jax(video):
    images = video[0][:3]
    uv_j, vis_j = jbuild_tracks(images, JTrackingConfig(n_keypoints=128))
    uv_t, vis_t = build_tracks(images, TrackingConfig(n_keypoints=128), device="cpu",
                               sampler=JaxTrackKeys(0))
    assert vis_j.shape[1] > 25
    np.testing.assert_array_equal(vis_t, vis_j)
    np.testing.assert_allclose(uv_t, uv_j, rtol=0, atol=1e-9)


def test_run_from_images_passes_the_reference_gates(video):
    """test_tracks.py::test_images_to_reconstruction's run and gates."""
    images, centers, _, _ = video
    intr = np.tile(np.array([test_tracks.FX, test_tracks.FY, test_tracks.CX, test_tracks.CY]),
                   (images.shape[0], 1))
    rec = run_from_images(
        images, intr, "pose", tracking=TrackingConfig(n_keypoints=256),
        incremental_config=IncrementalConfig(seed=4, pnp_threshold=3e-5,
                                             epipolar_threshold=3e-5),
        device="cpu",
    )
    assert rec.registered.all()
    C_est = metrics.camera_centers(rec.problem.R, rec.problem.t)
    assert float(metrics.ate_rmse(C_est, torch.as_tensor(centers))) < 0.15
    assert metrics.reprojection_rmse(rec.problem) < 1.5
