"""Host-side partition of a problem into point shards.

Port of :mod:`pysfm_tpu.dist.shard`, same layout:

- **points and their observations are sharded**: shard ``k`` owns the
  contiguous block of points ``[k*Pl, (k+1)*Pl)`` and every observation of
  them, with point ids relocalized to the shard;
- **cameras are replicated**: every rank holds the full camera arrays, and
  the camera-sized partials are summed over the ranks.

Padding gives every shard the same shape, as the JAX package's
``shard_map`` needs; here it keeps the stacked ``[n, ...]`` host structure
equal to the JAX package's arrays.  Padding points have no observations
(unit-filled Hpp, zero update); padding observations carry ``obs_w = 0``.

:func:`shard_problem` returns the whole stacked partition as CPU tensors;
:func:`device_put_sharded` puts one rank's shard (leading axis of size 1,
as ``shard_map`` hands a shard to its body) on the rank's device.  The
partition is deterministic, so every rank computes the same one without
communicating (:mod:`~pysfm_tpu_torch.dist.multihost` builds only the
calling rank's shard).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from pysfm_tpu_torch.utils.collectives import all_gather
from pysfm_tpu_torch.problem.problem import BundleProblem, build_point_obs_table

# Replicated camera state and sharded fields of ShardedProblem.
REPL_FIELDS = ("R", "t", "intr", "cam_fixed", "robust_scale")
SHARDED_FIELDS = (
    "X", "pt_mask", "obs_cam", "obs_pt", "obs_uv", "obs_w",
    "pt_obs", "pt_obs_mask", "cam_obs", "cam_obs_mask",
)


@dataclasses.dataclass(frozen=True)
class ShardedProblem:
    """Leading axis of the sharded fields is the shard axis [n, ...]."""

    # Replicated camera state.
    R: torch.Tensor            # [C, 3, 3]
    t: torch.Tensor            # [C, 3]
    intr: torch.Tensor         # [C, I]
    cam_fixed: torch.Tensor    # [C]
    # Sharded points.
    X: torch.Tensor            # [n, Pl, 3]
    pt_mask: torch.Tensor      # [n, Pl] bool, False for padding points
    # Sharded observations (point ids LOCAL to the shard).
    obs_cam: torch.Tensor      # [n, Ml]
    obs_pt: torch.Tensor       # [n, Ml]
    obs_uv: torch.Tensor       # [n, Ml, 2]
    obs_w: torch.Tensor        # [n, Ml]
    # Per-shard padded point-observation tables (local obs indices).
    pt_obs: torch.Tensor       # [n, Pl, K]
    pt_obs_mask: torch.Tensor  # [n, Pl, K] bool
    # Per-shard padded camera-observation tables (local obs indices); Kc is
    # the most observations of one camera in one shard.
    cam_obs: torch.Tensor       # [n, C, Kc]
    cam_obs_mask: torch.Tensor  # [n, C, Kc] bool
    robust_scale: torch.Tensor
    camera_model: str = "pose"
    robust: str = "gaussian"

    @property
    def n_shards(self) -> int:
        return self.X.shape[0]

    def replace(self, **changes) -> "ShardedProblem":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class Partition:
    """The point blocks of ``n`` shards over point-sorted observations and
    the padded sizes every shard shares."""

    pl: int              # points a shard (ceil(P / n))
    starts: np.ndarray   # [n] first observation of each shard
    ends: np.ndarray     # [n] one past its last
    ml: int              # observations a shard, padded
    K: int               # longest track
    Kc: int              # most observations of one camera in one shard


def partition(obs_pt: np.ndarray, obs_cam: np.ndarray, n_points: int,
              n_cameras: int, n_shards: int) -> Partition:
    """The deterministic global partition (the JAX package's): shard ``k``
    owns points ``[k*pl, (k+1)*pl)``.  The table widths are computed from
    the whole problem, so one shard built alone has the shapes it has in
    the stacked partition."""
    if np.any(np.diff(obs_pt) < 0):
        raise ValueError("observations must be sorted by point id")
    P_, n = n_points, n_shards
    pl = -(-P_ // n)
    starts = np.searchsorted(obs_pt, np.arange(n) * pl)
    ends = np.searchsorted(obs_pt, np.minimum((np.arange(n) + 1) * pl, P_))
    shard_of = obs_pt.astype(np.int64) // pl
    K = int(np.bincount(obs_pt, minlength=P_).max(initial=1))
    Kc = int(np.bincount(shard_of * n_cameras + obs_cam).max(initial=1))
    return Partition(pl=pl, starts=starts, ends=ends,
                     ml=int(np.max(ends - starts, initial=1)), K=K, Kc=Kc)


def pad_points(arr: np.ndarray, part: Partition, shards: Sequence[int], fill=0):
    """``arr [P, ...]`` cut into the point blocks of ``shards``: ``[len, Pl, ...]``."""
    P_ = arr.shape[0]
    out = np.full((len(shards), part.pl) + arr.shape[1:], fill, dtype=arr.dtype)
    for i, k in enumerate(shards):
        lo, hi = k * part.pl, min((k + 1) * part.pl, P_)
        out[i, : max(hi - lo, 0)] = arr[lo:hi]
    return out


def pad_obs(arr: np.ndarray, part: Partition, shards: Sequence[int], fill=0):
    """``arr [M, ...]`` cut into the observation slices of ``shards``:
    ``[len, Ml, ...]``."""
    out = np.full((len(shards), part.ml) + arr.shape[1:], fill, dtype=arr.dtype)
    for i, k in enumerate(shards):
        lo, hi = part.starts[k], part.ends[k]
        out[i, : hi - lo] = arr[lo:hi]
    return out


def local_obs_pt(obs_pt: np.ndarray, part: Partition, shards: Sequence[int]):
    """Observation point ids relocalized to their shard (padding: 0)."""
    op = pad_obs(obs_pt, part, shards)
    for i, k in enumerate(shards):
        op[i] -= k * part.pl
    return np.clip(op, 0, part.pl - 1)


def shard_tables(ids: np.ndarray, part: Partition, shards: Sequence[int],
                 n_rows: int, width: int):
    """Per-shard padded tables ``[len, n_rows, width]`` of the local
    observation indices of each row id (built on the real observations
    only, so padding observations are never referenced)."""
    tabs = np.zeros((len(shards), n_rows, width), np.int32)
    msks = np.zeros((len(shards), n_rows, width), bool)
    for i, k in enumerate(shards):
        n_real = int(part.ends[k] - part.starts[k])
        tabs[i], msks[i] = build_point_obs_table(ids[i, :n_real], n_rows, max_track=width)
    return tabs, msks


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def shard_problem(p: BundleProblem, n_shards: int,
                  shards: Optional[Sequence[int]] = None) -> ShardedProblem:
    """Partition a BundleProblem into ``n_shards`` point blocks (host-side,
    CPU tensors).  ``shards`` builds only those blocks of the same global
    partition (stacked in the given order); default all.

    Requires observations sorted by point id (``make_problem`` sorts
    them), so each shard's observations are a contiguous slice."""
    obs_pt, obs_cam = _host(p.obs_pt), _host(p.obs_cam)
    C = p.n_cameras
    part = partition(obs_pt, obs_cam, p.n_points, C, n_shards)
    shards = list(range(n_shards)) if shards is None else list(shards)
    oc = pad_obs(obs_cam, part, shards)
    op = local_obs_pt(obs_pt, part, shards)
    pt_obs, pt_obs_mask = shard_tables(op, part, shards, part.pl, part.K)
    cam_obs, cam_obs_mask = shard_tables(oc, part, shards, C, part.Kc)
    t = torch.as_tensor
    return ShardedProblem(
        R=p.R.cpu(), t=p.t.cpu(), intr=p.intr.cpu(), cam_fixed=p.cam_fixed.cpu(),
        X=t(pad_points(_host(p.X), part, shards)),
        pt_mask=t(pad_points(np.ones(p.n_points, bool), part, shards, fill=False)),
        obs_cam=t(oc), obs_pt=t(op),
        obs_uv=t(pad_obs(_host(p.obs_uv), part, shards)),
        obs_w=t(pad_obs(_host(p.obs_w), part, shards, fill=0.0)),
        pt_obs=t(pt_obs), pt_obs_mask=t(pt_obs_mask),
        cam_obs=t(cam_obs), cam_obs_mask=t(cam_obs_mask),
        robust_scale=p.robust_scale.cpu(),
        camera_model=p.camera_model, robust=p.robust,
    )


def take_shard(sp, k: int, device, sharded_fields=SHARDED_FIELDS,
               repl_fields=REPL_FIELDS):
    """Shard ``k`` of a stacked partition, with its leading axis kept (size
    1), and the replicated state, on ``device``."""
    changes = {f: getattr(sp, f)[k:k + 1].to(device) for f in sharded_fields}
    changes.update({f: getattr(sp, f).to(device) for f in repl_fields})
    return dataclasses.replace(sp, **changes)


def device_put_sharded(sp: ShardedProblem, mesh) -> ShardedProblem:
    """This rank's shard of the stacked partition ``sp`` (leading axis of
    size 1) and the replicated camera state, on ``mesh.device``."""
    if sp.n_shards != mesh.size:
        raise ValueError(f"{sp.n_shards} shards for a mesh of {mesh.size} ranks")
    return take_shard(sp, mesh.rank, mesh.device)


def gather_points(X: torch.Tensor, mask: torch.Tensor, mesh=None) -> torch.Tensor:
    """The global point array from the shards' ``X [n, Pl, ...]`` and
    ``pt_mask [n, Pl]``, in shard order, padding dropped.  With ``mesh``
    the arguments are this rank's shard (leading axis 1) and the blocks are
    all-gathered in rank order first."""
    if mesh is not None:
        X = all_gather(X, mesh, dim=0)
        mask = all_gather(mask.to(torch.uint8), mesh, dim=0).bool()
    return torch.cat([X[k][mask[k]] for k in range(X.shape[0])])


def unshard_points(sp: ShardedProblem, mesh=None) -> torch.Tensor:
    """The global ``X [P, 3]`` (host-side from the stacked partition, or
    all-gathered from each rank's shard with ``mesh``)."""
    return gather_points(sp.X, sp.pt_mask, mesh)


def unshard_problem(sp: ShardedProblem, template: BundleProblem, mesh=None) -> BundleProblem:
    """A BundleProblem with the solved parameters of ``sp`` and the
    measurements of ``template``."""
    X = unshard_points(sp, mesh).to(template.device)
    return template.replace(R=sp.R.to(template.device), t=sp.t.to(template.device),
                            intr=sp.intr.to(template.device), X=X)
