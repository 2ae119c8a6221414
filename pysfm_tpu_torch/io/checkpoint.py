"""Checkpoint / resume of bundle-adjustment state.

Port of :mod:`pysfm_tpu.io.checkpoint`, in the same file format, so a
checkpoint written by either package loads in the other: one ``.npz`` of
the problem's arrays (same field names, same dtypes) plus the damping state
``lam``, ``nu`` and ``iteration``, and a JSON sidecar with the static
metadata (``camera_model``, ``robust``, ``extra``, ``version``; ``layout``
"cm" for a component-major checkpoint).  A write goes to a temporary file
renamed into place, npz first and sidecar last: the sidecar's rename is
the commit marker, so a torn write is never visible.

As in the JAX package the CG warm start (``stats.dc_next``) is not stored:
a resumed pcg solve starts CG from zero.

Sharded checkpoints (:func:`save_checkpoint_sharded`,
:func:`save_checkpoint_sharded_cm`) use the JAX package's part format: each
rank writes one part ``<path>.p<rank>`` with its shards (the leading shard
axis), the replicated camera state, and ``shard_starts`` / ``shard_sizes``
saying which rows of the global shard axis it holds.  The loaders reassemble
every part at ``<path>.p*``, from either package, and refuse a checkpoint
whose parts leave a shard uncovered.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from pysfm_tpu_torch.problem import BundleProblem, make_problem


@dataclasses.dataclass
class SolverCheckpoint:
    """Everything needed to resume LM mid-solve."""

    problem: BundleProblem
    lam: float = 1e-3
    nu: float = 2.0
    iteration: int = 0
    rng_key: Optional[np.ndarray] = None
    extra: Optional[dict] = None


def _np(x) -> np.ndarray:
    """A host numpy array of a tensor or a Python / numpy value."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _commit(path: str, arrays: dict, meta: dict, compressed: bool) -> None:
    """Write the npz, then the sidecar, each through a tmp file + rename."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        (np.savez_compressed if compressed else np.savez)(f, **arrays)
    os.replace(tmp, path)
    with open(path + ".json.tmp", "w") as f:
        json.dump(meta, f)
    os.replace(path + ".json.tmp", path + ".json")


def save_checkpoint(path: str, ckpt: SolverCheckpoint) -> None:
    """Atomically write a checkpoint of a :class:`BundleProblem`."""
    p = ckpt.problem
    names = ("R", "t", "intr", "X", "obs_cam", "obs_pt", "obs_uv", "obs_w",
             "cam_fixed", "robust_scale")
    arrays = {name: _np(getattr(p, name)) for name in names}
    arrays.update(lam=_np(ckpt.lam), nu=_np(ckpt.nu), iteration=_np(ckpt.iteration))
    if ckpt.rng_key is not None:
        arrays["rng_key"] = _np(ckpt.rng_key)
    meta = {
        "camera_model": p.camera_model,
        "robust": p.robust,
        "extra": ckpt.extra or {},
        "version": 1,
    }
    _commit(path, arrays, meta, compressed=True)


def load_checkpoint(path: str, dtype=None, device="cuda") -> SolverCheckpoint:
    """Load a checkpoint written by :func:`save_checkpoint` (of either
    package) onto ``device`` (the card unless the caller asks for the
    CPU)."""
    with open(path + ".json") as f:
        meta = json.load(f)
    z = np.load(path)
    prob = make_problem(
        z["R"], z["t"], z["intr"], z["X"],
        z["obs_cam"], z["obs_pt"], z["obs_uv"],
        camera_model=meta["camera_model"], robust=meta["robust"],
        robust_scale=float(z["robust_scale"]),
        obs_w=z["obs_w"], cam_fixed=z["cam_fixed"], dtype=dtype, device=device,
    )
    return SolverCheckpoint(
        problem=prob,
        lam=float(z["lam"]),
        nu=float(z["nu"]),
        iteration=int(z["iteration"]),
        rng_key=z["rng_key"] if "rng_key" in z else None,
        extra=meta.get("extra") or None,
    )


# --------------------------------------------------------------------------
# Component-major (BAL-scale) checkpointing.
# --------------------------------------------------------------------------

_CM_FIELDS = (
    "R", "t", "intr", "cam_fixed", "X3", "obs_cam", "obs_pt", "u", "v",
    "obs_w", "pt_obsT", "pt_obs_maskT", "cam_obs", "cam_obs_mask",
    "robust_scale",
)


def save_checkpoint_cm(
    path: str,
    cmp,
    *,
    lam: float = 1e-3,
    nu: float = 2.0,
    iteration: int = 0,
    extra: Optional[dict] = None,
) -> None:
    """Atomically save a :class:`~pysfm_tpu_torch.problem.cm.CMProblem`
    mid-solve (the segment boundary of ``lm.solve_segmented``).
    Uncompressed npz: at millions of observations zlib costs far more than
    the write."""
    arrays = {name: _np(getattr(cmp, name)) for name in _CM_FIELDS}
    arrays.update(lam=_np(lam), nu=_np(nu), iteration=_np(iteration))
    meta = {
        "camera_model": cmp.camera_model,
        "robust": cmp.robust,
        "extra": extra or {},
        "version": 1,
        "layout": "cm",
    }
    _commit(path, arrays, meta, compressed=False)


def load_checkpoint_cm(path: str, device="cuda"):
    """Load a CM checkpoint onto ``device``; returns ``(CMProblem, lam, nu,
    iteration)``.  Build ``make_grouped_ops`` anew for the loaded problem:
    its layout is a function of (obs_cam, obs_pt) alone."""
    from pysfm_tpu_torch.problem import cm

    with open(path + ".json") as f:
        meta = json.load(f)
    if meta.get("layout") != "cm":
        raise ValueError(f"{path} is not a CM checkpoint")
    z = np.load(path)
    cmp = cm.from_numpy({name: z[name] for name in _CM_FIELDS},
                        meta["camera_model"], meta["robust"], device=device)
    return cmp, float(z["lam"]), float(z["nu"]), int(z["iteration"])


# --------------------------------------------------------------------------
# Sharded checkpoints (the distributed solvers' state).
# --------------------------------------------------------------------------


def _check_shard_coverage(path: str, n: int, covered: np.ndarray) -> None:
    """Raise unless the parts cover every row of the shard axis: a missing
    or torn part (a rank that died before writing) must not resume as
    zero-filled shards."""
    if not covered.all():
        missing = np.flatnonzero(~covered)
        raise ValueError(
            f"checkpoint {path!r} is incomplete: {missing.size} of {n} shard rows "
            f"(first {int(missing[0])}, last {int(missing[-1])}) are covered by no "
            "part file; refusing to resume from zero-filled state"
        )


def _save_parts(path, obj, sharded_fields, repl_fields, lam, nu, iteration,
                mesh, meta, compressed) -> str:
    """One part file of ``obj``'s shards.  Without ``mesh`` ``obj`` is the
    whole stacked partition (part 0, rows ``[0, n)``); with ``mesh`` it is
    this rank's shard (part ``mesh.rank``, row ``mesh.rank`` of
    ``mesh.size``)."""
    arrays = {name: _np(getattr(obj, name)) for name in repl_fields}
    arrays.update(lam=_np(lam), nu=_np(nu), iteration=_np(iteration))
    sizes = {getattr(obj, name).shape[0] for name in sharded_fields}
    if len(sizes) != 1:
        raise ValueError(f"sharded fields disagree on the shard axis: sizes {sorted(sizes)}")
    rows = sizes.pop()
    start, n, part = (0, rows, 0) if mesh is None else (mesh.rank, mesh.size, mesh.rank)
    if start + rows > n:
        raise ValueError(f"{rows} shard rows at {start} do not fit {n} shards")
    for name in sharded_fields:
        arrays[name] = _np(getattr(obj, name))
    arrays["shard_starts"] = np.asarray([start], np.int64)
    arrays["shard_sizes"] = np.asarray([rows], np.int64)
    out = f"{path}.p{part}"
    _commit(out, arrays, dict(meta, n_shards=int(n), version=1), compressed)
    return out


def _load_parts(path: str, sharded_fields, repl_fields):
    """(fields as CPU tensors, meta, lam, nu, iteration) reassembled from
    every part at ``<path>.p*``."""
    import glob

    parts = sorted(q for q in glob.glob(path + ".p*") if not q.endswith((".json", ".tmp")))
    if not parts:
        raise FileNotFoundError(f"no checkpoint parts at {path}.p*")
    with open(parts[0] + ".json") as f:
        meta = json.load(f)
    loaded = [np.load(q) for q in parts]
    n = meta["n_shards"]
    fields = {name: torch.as_tensor(loaded[0][name]) for name in repl_fields}
    covered = np.zeros(n, bool)
    for name in sharded_fields:
        out = None
        for z in loaded:
            arr = z[name]
            if out is None:
                out = np.zeros((n,) + arr.shape[1:], arr.dtype)
            off = 0
            for s0, sz in zip(z["shard_starts"], z["shard_sizes"]):
                out[int(s0):int(s0) + int(sz)] = arr[off:off + int(sz)]
                covered[int(s0):int(s0) + int(sz)] = True
                off += int(sz)
        fields[name] = torch.as_tensor(out)
    _check_shard_coverage(path, n, covered)
    z0 = loaded[0]
    return fields, meta, float(z0["lam"]), float(z0["nu"]), int(z0["iteration"])


def save_checkpoint_sharded(path: str, sp, *, lam: float = 1e-3, nu: float = 2.0,
                            iteration: int = 0, mesh=None) -> str:
    """Save a :class:`~pysfm_tpu_torch.dist.shard.ShardedProblem` mid-solve:
    with ``mesh`` every rank calls it with its own shard and writes part
    ``<path>.p<rank>`` (no gather); without, the stacked partition goes
    into one part.  Atomic (tmp + rename, sidecar last).  Returns the part
    path written."""
    from pysfm_tpu_torch.dist import shard

    meta = {"camera_model": sp.camera_model, "robust": sp.robust, "sharded": True}
    return _save_parts(path, sp, shard.SHARDED_FIELDS, shard.REPL_FIELDS, lam, nu,
                       iteration, mesh, meta, compressed=True)


def load_checkpoint_sharded(path: str):
    """Reassemble a sharded checkpoint from all parts at ``<path>.p*``;
    returns ``(ShardedProblem, lam, nu, iteration)`` as CPU tensors (place
    a rank's shard with ``dist.device_put_sharded``)."""
    from pysfm_tpu_torch.dist import shard

    fields, meta, lam, nu, it = _load_parts(path, shard.SHARDED_FIELDS, shard.REPL_FIELDS)
    sp = shard.ShardedProblem(camera_model=meta["camera_model"], robust=meta["robust"],
                              **fields)
    return sp, lam, nu, it


def save_checkpoint_sharded_cm(path: str, scm, *, lam: float = 1e-3, nu: float = 2.0,
                               iteration: int = 0, mesh=None) -> str:
    """Save a :class:`~pysfm_tpu_torch.dist.sharded_cm.ShardedCMProblem`
    mid-solve, one part per rank as :func:`save_checkpoint_sharded`
    (uncompressed).  The kernel operands are not saved: they are a function
    of (obs_cam, obs_pt) and ``dist.device_put_sharded_cm`` rebuilds them."""
    from pysfm_tpu_torch.dist import sharded_cm

    meta = {"camera_model": scm.camera_model, "robust": scm.robust, "sharded_cm": True}
    return _save_parts(path, scm, sharded_cm.SHARDED_FIELDS, sharded_cm.REPL_FIELDS,
                       lam, nu, iteration, mesh, meta, compressed=False)


def load_checkpoint_sharded_cm(path: str):
    """Reassemble a sharded CM checkpoint from all parts at ``<path>.p*``;
    returns ``(ShardedCMProblem, lam, nu, iteration)`` as CPU tensors."""
    from pysfm_tpu_torch.dist import sharded_cm

    fields, meta, lam, nu, it = _load_parts(
        path, sharded_cm.SHARDED_FIELDS, sharded_cm.REPL_FIELDS)
    if not meta.get("sharded_cm"):
        raise ValueError(f"{path} is not a sharded CM checkpoint")
    scm = sharded_cm.ShardedCMProblem(camera_model=meta["camera_model"],
                                      robust=meta["robust"], **fields)
    return scm, lam, nu, it


def latest_checkpoint(directory: str, prefix: str = "ckpt") -> Optional[str]:
    """Newest complete checkpoint in ``directory`` (by iteration suffix
    ``<prefix>_<iteration>.npz``), or None."""
    best = None
    for name in os.listdir(directory):
        if not (name.startswith(prefix + "_") and name.endswith(".npz")):
            continue
        stem = name[len(prefix) + 1 : -4]
        if not stem.isdigit():
            continue
        full = os.path.join(directory, name)
        if not os.path.exists(full + ".json"):
            continue  # torn write: the sidecar's rename is the commit marker
        it = int(stem)
        if best is None or it > best[0]:
            best = (it, full)
    return best[1] if best else None
