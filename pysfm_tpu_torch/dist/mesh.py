"""The process mesh: one process per rank, one point shard per rank.

Port of :mod:`pysfm_tpu.dist.mesh`.  The JAX package runs one controller
over a :class:`jax.sharding.Mesh` of devices and names the shard axis
:data:`AXIS`; collectives are ``psum``/``pmax`` over that axis.  PyTorch's
idiom is one process per rank joined in a ``torch.distributed`` process
group, and :class:`Mesh` is its counterpart: this process's rank, the world
size, the backend, and the device the rank's shard lives on.  Solver
functions take it as ``group=`` where the JAX functions take
``axis_name=``; ``group=None`` is the single-device code path.

The backend is the process group's (:func:`pysfm_tpu_torch.dist.multihost.
initialize`): NCCL on ``cuda:LOCAL_RANK`` by default, gloo on the CPU when
the caller asks for ``device="cpu"``, or gloo on CUDA tensors when the
caller names that backend.  Nothing here changes a backend or a device
behind the caller's back.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as tdist

# The single data-parallel axis of point-sharded Schur BA (the JAX name).
AXIS = "shard"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ranks over the world (default) process group: this
    process's place in it.

    No reference to the world's ProcessGroup object is kept: one that
    outlives ``destroy_process_group()`` is torn down at interpreter exit,
    after the threads it owns, and aborts the process."""

    rank: int
    size: int
    device: torch.device   # where this rank's shard and its collectives live
    backend: str           # "nccl" or "gloo"


def default_device() -> torch.device:
    """``cuda:LOCAL_RANK`` (torchrun's variable; 0 without it)."""
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh over the joined world (call
    :func:`~pysfm_tpu_torch.dist.multihost.initialize` first).

    ``n_devices``, when given, must equal the world size: a process that
    is not a rank of the mesh would have no shard to hold.  ``device`` is
    the rank's device (default ``cuda:LOCAL_RANK``); NCCL takes CUDA
    devices only, gloo either kind.
    """
    if not tdist.is_initialized():
        raise RuntimeError(
            "make_mesh: no process group; call dist.multihost.initialize() first"
        )
    size = tdist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(
            f"requested a mesh of {n_devices} ranks, the world has {size}"
        )
    device = default_device() if device is None else torch.device(device)
    backend = str(tdist.get_backend())
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, got {device}")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r}")
    return Mesh(rank=tdist.get_rank(), size=size, device=device, backend=backend)
