"""Two-view bundle adjustment on a synthetic scene (BASELINE config 1).

Counterpart of the JAX package's ``examples/two_view_ba.py``: the same
two-camera scene and ``solve()`` with the default ``LMConfig`` (the dense
component-major Schur LM; an f32 problem on the card takes the projection
kernel, ``csrc/proj.cu``, once per LM iteration).  The run asserts the
script's own criterion: the final reprojection RMSE below twice the
measurement noise (0.5 px).

Run:

    python -m pysfm_tpu_torch.examples.two_view_ba                # the card
    python -m pysfm_tpu_torch.examples.two_view_ba --device cpu
"""

from __future__ import annotations

import numpy as np

from pysfm_tpu_torch.examples import parser, require_device
from pysfm_tpu_torch.pipeline import synthetic
from pysfm_tpu_torch.solver import LMConfig, solve
from pysfm_tpu_torch.utils import metrics

NOISE_PX = 0.5
SCENE = dict(n_cameras=2, n_points=100, noise_px=NOISE_PX, perturb_rot=0.05,
             perturb_trans=0.1, perturb_point=0.1, seed=0)
MAX_ITERS = 30


def run(device="cuda", dtype=np.float32) -> dict:
    """Build the scene on ``device`` in ``dtype`` and solve it; returns the
    problem, the solved problem, the LM stats and what the script prints."""
    p = synthetic.make_scene(**SCENE, dtype=dtype, device=require_device(device)).problem
    solved, stats = solve(p, LMConfig(max_iters=MAX_ITERS))
    costs = stats.costs.cpu().numpy()
    return dict(problem=p, solved=solved, stats=stats, n_cameras=p.n_cameras,
                n_points=p.n_points, n_obs=p.n_obs, cost0=float(costs[0]),
                cost=float(costs[-1]), n_iters=int(stats.n_iters),
                accepted=int(stats.accepted.sum()), rmse=metrics.reprojection_rmse(solved))


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    out = run(args.device)
    print(f"problem: {out['n_cameras']} cams, {out['n_points']} pts, {out['n_obs']} obs "
          f"({args.device})")
    print(f"cost {out['cost0']:.2f} -> {out['cost']:.4f} in {out['n_iters']} iters "
          f"({out['accepted']} accepted)")
    print(f"final reprojection RMSE {out['rmse']:.4f} px (noise floor ~{NOISE_PX} px)")
    if not out["rmse"] < 2.0 * NOISE_PX:
        raise AssertionError("did not reach the noise floor")
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
