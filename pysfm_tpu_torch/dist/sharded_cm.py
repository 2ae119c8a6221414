"""The distributed pcg route: the component-major LM loop over a process
group (BASELINE config 5).

Port of :mod:`pysfm_tpu.dist.sharded_cm`, with the partition of
:mod:`~pysfm_tpu_torch.dist.shard`:

- **points, observations and the kernel operands are sharded**: rank ``k``
  owns a contiguous block of points and all their observations (point-
  sorted, so a contiguous slice), and builds its own
  :class:`~pysfm_tpu_torch.solver.kernels.spmv.GroupedOps` over them;
- **cameras are replicated**; the camera-sized partials are summed over
  the ranks: Hcc and g_c once per linearization in ``solver/lm.py``, the
  reduced rhs, the block-Jacobi diagonal and each CG product in
  ``solver/pcg.py`` (``group=``);
- the LM loop is :func:`pysfm_tpu_torch.solver.lm.cm_lm_loop`, the same
  function the single-device route runs, with ``group`` set.

The JAX module pads every shard's grouped stream to one static block count
for ``shard_map``'s one shape and the TPU's two-phase schedule; here each
rank builds its own operands at its own size, and nothing is padded.

Traffic of one LM iteration: one sum of ``[C, CP, CP]`` + ``[C, CP]``
(Hcc, g_c) per linearization, one of the reduced rhs and the
preconditioner's diagonal, one ``[CP, C]`` sum per CG iteration, and the
scalar cost / predicted-reduction / step-norm sums and the gradient-norm
maximum.
Point-sized state never moves.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pysfm_tpu_torch.dist.shard import (
    gather_points, local_obs_pt, pad_obs, pad_points, partition, shard_tables,
    take_shard,
)
from pysfm_tpu_torch.problem import cm as cm_mod
from pysfm_tpu_torch.solver.lm import LMStats, cm_lm_loop, make_grouped_ops
from pysfm_tpu_torch.utils.config import LMConfig

REPL_FIELDS = ("R", "t", "intr", "cam_fixed", "robust_scale")
SHARDED_FIELDS = (
    "X3", "pt_mask", "obs_cam", "obs_pt", "u", "v", "obs_w",
    "pt_obsT", "pt_obs_maskT", "cam_obs", "cam_obs_mask",
)


@dataclasses.dataclass(frozen=True)
class ShardedCMProblem:
    """Component-major problem partitioned over the ranks.

    Sharded fields carry a leading shard axis ``[n, ...]``; camera state is
    replicated.  Observation ids are LOCAL: ``obs_pt`` is relative to the
    shard's point block, ``obs_cam`` stays global (cameras replicated)."""

    # Replicated camera state.
    R: torch.Tensor              # [C, 3, 3]
    t: torch.Tensor              # [C, 3]
    intr: torch.Tensor           # [C, I]
    cam_fixed: torch.Tensor      # [C]
    robust_scale: torch.Tensor
    # Sharded points (component-major) and validity.
    X3: torch.Tensor             # [n, 3, Pl]
    pt_mask: torch.Tensor        # [n, Pl] bool
    # Sharded observations (point-sorted; padding slots carry obs_w = 0).
    obs_cam: torch.Tensor        # [n, Ml]
    obs_pt: torch.Tensor         # [n, Ml] local point ids
    u: torch.Tensor              # [n, Ml]
    v: torch.Tensor              # [n, Ml]
    obs_w: torch.Tensor          # [n, Ml]
    # Sharded visibility tables (local obs indices).
    pt_obsT: torch.Tensor        # [n, K, Pl]
    pt_obs_maskT: torch.Tensor   # [n, K, Pl]
    cam_obs: torch.Tensor        # [n, C, Kc]
    cam_obs_mask: torch.Tensor   # [n, C, Kc]
    camera_model: str = "bal"
    robust: str = "gaussian"

    @property
    def n_shards(self) -> int:
        return self.X3.shape[0]

    @property
    def n_points_global(self) -> int:
        return self.X3.shape[0] * self.X3.shape[2]

    def replace(self, **changes) -> "ShardedCMProblem":
        return dataclasses.replace(self, **changes)


def shard_cm_problem(
    cmp: cm_mod.CMProblem, n_shards: int, shards: Optional[Sequence[int]] = None
) -> ShardedCMProblem:
    """Partition a CMProblem into ``n_shards`` point blocks (host-side, CPU
    tensors); ``shards`` builds only those blocks of the global partition.
    Every shard needs at least one observation."""
    obs_pt, obs_cam = cmp.obs_pt.cpu().numpy(), cmp.obs_cam.cpu().numpy()
    C = cmp.n_cameras
    part = partition(obs_pt, obs_cam, cmp.n_points, C, n_shards)
    counts = part.ends - part.starts
    if np.any(counts <= 0):
        raise ValueError(
            f"every shard needs at least one observation; got counts {list(counts)}"
        )
    shards = list(range(n_shards)) if shards is None else list(shards)
    oc = pad_obs(obs_cam, part, shards)
    op = local_obs_pt(obs_pt, part, shards)
    pt_obs, pt_obs_mask = shard_tables(op, part, shards, part.pl, part.K)
    cam_obs, cam_obs_mask = shard_tables(oc, part, shards, C, part.Kc)
    host = {f: getattr(cmp, f).cpu().numpy() for f in ("X3", "u", "v", "obs_w")}
    t = torch.as_tensor
    return ShardedCMProblem(
        R=cmp.R.cpu(), t=cmp.t.cpu(), intr=cmp.intr.cpu(),
        cam_fixed=cmp.cam_fixed.cpu(), robust_scale=cmp.robust_scale.cpu(),
        X3=t(pad_points(host["X3"].T, part, shards)).transpose(1, 2).contiguous(),
        pt_mask=t(pad_points(np.ones(cmp.n_points, bool), part, shards, fill=False)),
        obs_cam=t(oc), obs_pt=t(op),
        u=t(pad_obs(host["u"], part, shards, fill=0.0)),
        v=t(pad_obs(host["v"], part, shards, fill=0.0)),
        obs_w=t(pad_obs(host["obs_w"], part, shards, fill=0.0)),
        pt_obsT=t(pt_obs).transpose(1, 2).contiguous(),
        pt_obs_maskT=t(pt_obs_mask).transpose(1, 2).contiguous(),
        cam_obs=t(cam_obs), cam_obs_mask=t(cam_obs_mask),
        camera_model=cmp.camera_model, robust=cmp.robust,
    )


def _local_cm(scm: ShardedCMProblem) -> cm_mod.CMProblem:
    """This rank's shard (leading axis stripped) as a CMProblem."""
    return cm_mod.CMProblem(
        R=scm.R, t=scm.t, intr=scm.intr, cam_fixed=scm.cam_fixed,
        X3=scm.X3[0], obs_cam=scm.obs_cam[0], obs_pt=scm.obs_pt[0],
        u=scm.u[0], v=scm.v[0], obs_w=scm.obs_w[0],
        pt_obsT=scm.pt_obsT[0], pt_obs_maskT=scm.pt_obs_maskT[0],
        cam_obs=scm.cam_obs[0], cam_obs_mask=scm.cam_obs_mask[0],
        robust_scale=scm.robust_scale,
        camera_model=scm.camera_model, robust=scm.robust,
    )


def local_grouped_ops(scm: ShardedCMProblem):
    """The kernel operands of this rank's shard: ``make_grouped_ops`` over
    its real observations (the padding observations sit after them, and
    the point table holds every real one)."""
    lp = _local_cm(scm)
    n_real = int(scm.pt_obs_maskT[0].sum())
    return make_grouped_ops(lp.replace(
        obs_cam=lp.obs_cam[:n_real], obs_pt=lp.obs_pt[:n_real], u=lp.u[:n_real],
        v=lp.v[:n_real], obs_w=lp.obs_w[:n_real],
    ))


def _put_local(scm: ShardedCMProblem, k: int, device, with_grouped: bool):
    local = take_shard(scm, k, device, SHARDED_FIELDS, REPL_FIELDS)
    return local, (local_grouped_ops(local) if with_grouped else None)


def device_put_sharded_cm(
    scm: ShardedCMProblem, mesh, with_grouped: bool = True
) -> Tuple[ShardedCMProblem, Optional[object]]:
    """This rank's shard of ``scm`` (leading axis of size 1) and the
    replicated camera state on ``mesh.device``, and with ``with_grouped``
    its kernel operands (``GroupedOps`` over the shard), else None."""
    if scm.n_shards != mesh.size:
        raise ValueError(f"{scm.n_shards} shards for a mesh of {mesh.size} ranks")
    return _put_local(scm, mesh.rank, mesh.device, with_grouped)


def solve_sharded_cm(
    scm: ShardedCMProblem,
    sgops,
    mesh,
    config: LMConfig = LMConfig(solver="pcg"),
    lam_init=None,
    nu_init=None,
    cam_axis: bool = False,
) -> Tuple[ShardedCMProblem, LMStats]:
    """Distributed CM LM solve, run by every rank on its shard ``scm`` (from
    :func:`device_put_sharded_cm`).

    ``sgops`` (the rank's ``GroupedOps``) routes the cost, the build and
    every product with Hcp through the kernels of ``solver/kernels/spmv.py``
    on the rank's shard; ``sgops=None`` runs the plain route, which keeps
    the problem's dtype (the f64 equality tests).  An f64 problem drops
    ``sgops`` as the single-device loop does.

    ``cam_axis=True`` also partitions the camera axis of the reduced solve
    over the ranks (rank k owns point block k and camera slice k; see
    :class:`~pysfm_tpu_torch.solver.pcg.CamShard`).  Returns this rank's
    solved shard and the stats, the same on every rank."""
    solved, stats = cm_lm_loop(
        _local_cm(scm), config, lam_init, nu_init, gops=sgops, group=mesh,
        cam_shards=mesh.size if cam_axis else 0,
    )
    return scm.replace(R=solved.R, t=solved.t, intr=solved.intr, X3=solved.X3[None]), stats


def unshard_cm(scm: ShardedCMProblem, template: cm_mod.CMProblem, mesh=None) -> cm_mod.CMProblem:
    """A CMProblem with the solved parameters of ``scm`` and the
    measurements of ``template``: host-side from the stacked partition, or
    with ``mesh`` from each rank's shard, the point blocks all-gathered in
    rank order."""
    X = gather_points(scm.X3.transpose(1, 2), scm.pt_mask, mesh)   # [P, 3]
    dev = template.device
    return template.replace(R=scm.R.to(dev), t=scm.t.to(dev), intr=scm.intr.to(dev),
                            X3=X.T.contiguous().to(dev))
