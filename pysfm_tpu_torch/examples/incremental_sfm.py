"""Incremental SfM on a 10-keyframe synthetic sequence (BASELINE config 2).

Counterpart of the JAX package's ``examples/incremental_sfm.py``: the same
scene as a dense track table ``(uv, vis)``, as a tracker would produce
(``pipeline/tracks.py`` builds such a table from images), through
``run_incremental``: two-view bootstrap, next-best-view PnP registration,
triangulation of new tracks, windowed bundle adjustment.  An f32 table on
the card takes the projection kernel (``csrc/proj.cu``) in every BA solve.
The run asserts the script's own criterion: every frame registered and the
camera centres' ATE after Sim(3) alignment below 2e-2 on a radius-10 scene.

The RANSAC draws come from a ``torch.Generator`` seeded from the config;
``run(sampler=...)`` takes any sampler ``run_incremental`` takes.

Run:

    python -m pysfm_tpu_torch.examples.incremental_sfm                # the card
    python -m pysfm_tpu_torch.examples.incremental_sfm --device cpu
"""

from __future__ import annotations

import numpy as np

from pysfm_tpu_torch.examples import parser, require_device
from pysfm_tpu_torch.pipeline import IncrementalConfig, run_incremental, synthetic
from pysfm_tpu_torch.utils import metrics

SCENE = dict(n_cameras=10, n_points=300, noise_px=0.3, visibility=0.85, seed=13,
             radius=10.0)
SEED = 2
ATE_GATE = 2e-2


def track_table(dtype=np.float32):
    """``(uv [F, T, 2], vis [F, T], intr [F, 4], truth)``: the scene's
    observations as a dense track table in ``dtype``; the ground truth stays
    on the host in f64."""
    truth = synthetic.make_scene(**SCENE, dtype=np.float64, device="cpu").truth
    oc, op = truth.obs_cam.numpy(), truth.obs_pt.numpy()
    uv = np.zeros((truth.n_cameras, truth.n_points, 2), dtype)
    vis = np.zeros((truth.n_cameras, truth.n_points), bool)
    uv[oc, op] = truth.obs_uv.numpy()
    vis[oc, op] = True
    return uv, vis, truth.intr.numpy().astype(dtype), truth


def run(device="cuda", dtype=np.float32, sampler=None) -> dict:
    """Run the pipeline on the track table in ``dtype`` on ``device``;
    returns the reconstruction and what the script prints (the ATE after
    Sim(3) alignment computed in f64 on the host)."""
    dev = require_device(device)
    uv, vis, intr, truth = track_table(dtype)
    rec = run_incremental(uv, vis, intr, "pose", IncrementalConfig(seed=SEED), device=dev,
                          sampler=sampler)
    C_est = metrics.camera_centers(rec.problem.R.double().cpu(), rec.problem.t.double().cpu())
    ate = float(metrics.ate_rmse(C_est, metrics.camera_centers(truth.R, truth.t)))
    return dict(rec=rec, registered=int(rec.registered.sum()), n_frames=len(rec.registered),
                n_points=int(rec.has_point.sum()), ate=ate,
                rmse=metrics.reprojection_rmse(rec.problem))


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    out = run(args.device)
    print(f"registered {out['registered']}/{out['n_frames']} frames, {out['n_points']} points "
          f"triangulated ({args.device})")
    print(f"ATE (Sim(3)-aligned) {out['ate']:.5f} on a radius-10 scene; reprojection RMSE "
          f"{out['rmse']:.3f} px")
    if not (out["rec"].registered.all() and out["ate"] < ATE_GATE):
        raise AssertionError(f"registered {out['registered']}/{out['n_frames']}, ATE "
                             f"{out['ate']:.3e} (gate {ATE_GATE})")
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
