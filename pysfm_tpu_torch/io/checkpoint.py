"""Checkpoint / resume of bundle-adjustment state, single device.

Port of :mod:`pysfm_tpu.io.checkpoint`, in the same file format, so a
checkpoint written by either package loads in the other: one ``.npz`` of
the problem's arrays (same field names, same dtypes) plus the damping state
``lam``, ``nu`` and ``iteration``, and a JSON sidecar with the static
metadata (``camera_model``, ``robust``, ``extra``, ``version``; ``layout``
"cm" for a component-major checkpoint).  A write goes to a temporary file
renamed into place, npz first and sidecar last: the sidecar's rename is
the commit marker, so a torn write is never visible.

As in the JAX package the CG warm start (``stats.dc_next``) is not stored:
a resumed pcg solve starts CG from zero.  The sharded savers and loaders
come with the distributed port.
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


def _sharded(*args, **kwargs):
    raise NotImplementedError(
        "sharded checkpoints come with the distributed port (ROADMAP.md queue 1, item 13)"
    )


save_checkpoint_sharded = load_checkpoint_sharded = _sharded
save_checkpoint_sharded_cm = load_checkpoint_sharded_cm = _sharded


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
