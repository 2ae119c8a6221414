"""Distributed Levenberg-Marquardt: point-sharded Schur BA over a process
group.

Port of :mod:`pysfm_tpu.dist.sharded_lm`.  Points are eliminated on their
rank and the reduced camera system is summed over the ranks.  Every rank
runs the same host loop, the single-device loop of ``solver/lm.py`` with
``group`` set; the traffic of one iteration is

- the sum of the camera partials Hcc and g_c, once per linearization;
- the sums of what the points add to the reduced system (the partial S and
  its rhs on the dense routes; the reduced rhs, the preconditioner's
  diagonal and each CG product's partial on the pcg route);
- the sums of the scalar cost, predicted reduction and step norm, and the
  maximum of the gradient norm.

Every control quantity (lam, nu, accept, stop) is computed from reduced
values, so it is the same on every rank and the ranks never diverge: the
loop's host reads read such values.

Three branches, as in the JAX module: ``solver="pcg"`` (the
component-major pcg loop, the single-device pcg route), the dense
component-major route (``layout`` "auto" / "cm"; an f32 problem on a CUDA
device takes the projection kernel on every shard, the JAX module's
``use_pallas`` rule), and the dense standard layout.
"""

from __future__ import annotations

from typing import Tuple

from pysfm_tpu_torch.dist.shard import ShardedProblem
from pysfm_tpu_torch.problem import cm
from pysfm_tpu_torch.problem import problem as problem_mod
from pysfm_tpu_torch.solver.lm import LMStats, _solve_std, cm_lm_loop
from pysfm_tpu_torch.utils.config import LMConfig


def _local_problem(sp: ShardedProblem) -> problem_mod.BundleProblem:
    """This rank's shard (leading axis stripped) as a BundleProblem, so the
    single-device evaluation code runs on it unchanged."""
    return problem_mod.BundleProblem(
        R=sp.R, t=sp.t, intr=sp.intr, X=sp.X[0],
        obs_cam=sp.obs_cam[0], obs_pt=sp.obs_pt[0], obs_uv=sp.obs_uv[0],
        obs_w=sp.obs_w[0], pt_obs=sp.pt_obs[0], pt_obs_mask=sp.pt_obs_mask[0],
        cam_obs=sp.cam_obs[0], cam_obs_mask=sp.cam_obs_mask[0],
        cam_fixed=sp.cam_fixed, robust_scale=sp.robust_scale,
        camera_model=sp.camera_model, robust=sp.robust,
    )


def solve_sharded(
    sp: ShardedProblem, mesh, config: LMConfig = LMConfig()
) -> Tuple[ShardedProblem, LMStats]:
    """Distributed LM solve, run by every rank of ``mesh`` on its shard
    ``sp`` (from :func:`~pysfm_tpu_torch.dist.shard.device_put_sharded`).
    Returns this rank's solved shard and the stats, which are the same on
    every rank."""
    p = _local_problem(sp)
    if config.solver == "pcg":
        cmp, stats = cm_lm_loop(cm.from_problem(p), config, group=mesh)
        p = cm.merge_params(p, cmp)
    else:
        p, stats = _solve_std(p, config, group=mesh)
    return sp.replace(R=p.R, t=p.t, intr=p.intr, X=p.X[None]), stats
