"""Multi-process glue: join the process group, the mesh over the world, and
each rank's own shard.

Port of :mod:`pysfm_tpu.dist.multihost`.  One process per GPU (torchrun's
launch, or :func:`pysfm_tpu_torch.dist.launch.spawn`), joined by
``torch.distributed.init_process_group`` over ``tcp://MASTER_ADDR:
MASTER_PORT``; then the same 1-D point-shard mesh spans every rank, NCCL
carrying the sums within a host (NVLink) and across hosts.  No transport
code lives here.

Sharded data loading: each rank builds only its own point shard.  The
partition is deterministic (:func:`~pysfm_tpu_torch.dist.shard.partition`),
so the ranks agree on it without communicating.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as tdist

from pysfm_tpu_torch.dist import mesh as mesh_mod
from pysfm_tpu_torch.dist import shard as shard_mod
from pysfm_tpu_torch.dist.shard import ShardedProblem, shard_problem  # noqa: F401
from pysfm_tpu_torch.problem import BundleProblem  # noqa: F401


def free_port() -> int:
    """A free TCP port on localhost (for a world on one machine)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _partial(got, missing):
    raise RuntimeError(
        f"multihost.initialize: partial multi-host configuration: got {got} but "
        f"missing {missing} (set all of MASTER_ADDR / MASTER_PORT / WORLD_SIZE / "
        "RANK, or pass them)"
    )


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device=None,
    timeout: Optional[float] = None,
) -> None:
    """Join the process group (idempotent).

    ``coordinator_address`` is ``host:port`` (default: ``MASTER_ADDR`` and
    ``MASTER_PORT``), ``num_processes`` the world size (``WORLD_SIZE``),
    ``process_id`` this process's rank (``RANK``): torchrun's variables.
    A partial configuration raises: each process would otherwise solve its
    own shard as if it were the whole world.  With nothing configured the
    process joins a world of one on a free localhost port.

    ``backend`` defaults to NCCL, or gloo when ``device`` is the CPU;
    ``timeout`` (seconds) bounds every collective, so a rank that stops
    answering fails the others instead of hanging them.
    """
    if tdist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None:
        addr, port = env.get("MASTER_ADDR"), env.get("MASTER_PORT")
        if (addr is None) != (port is None):
            _partial(["MASTER_ADDR" if addr is not None else "MASTER_PORT"],
                     ["MASTER_PORT" if addr is not None else "MASTER_ADDR"])
        if addr is not None:
            coordinator_address = f"{addr}:{port}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    given = {
        "coordinator_address": coordinator_address,
        "num_processes": num_processes,
        "process_id": process_id,
    }
    supplied = sorted(k for k, v in given.items() if v is not None)
    if supplied and len(supplied) != len(given):
        _partial(supplied, sorted(set(given) - set(supplied)))
    if not supplied:
        coordinator_address, num_processes, process_id = f"localhost:{free_port()}", 1, 0
    device = mesh_mod.default_device() if device is None else torch.device(device)
    if backend is None:
        backend = "gloo" if device.type == "cpu" else "nccl"
    if backend == "nccl":
        torch.cuda.set_device(device)
    kwargs = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    tdist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id), **kwargs,
    )


def shutdown() -> None:
    """Leave the process group (no-op if not joined): wait for every rank,
    then destroy it, so no rank tears its connections down while another
    still uses them (rank 0 also serves the rendezvous store)."""
    if tdist.is_initialized():
        tdist.barrier()
        tdist.destroy_process_group()


def global_mesh(device=None) -> mesh_mod.Mesh:
    """The 1-D mesh over every rank of the world (after :func:`initialize`)."""
    return mesh_mod.make_mesh(device=device)


def shard_problem_multihost(p: BundleProblem, mesh) -> ShardedProblem:
    """This rank's shard of the global partition of ``p`` over the mesh,
    built alone (no other rank's points are materialized) and placed on
    ``mesh.device``; ready for :func:`~pysfm_tpu_torch.dist.solve_sharded`."""
    sp = shard_problem(p, mesh.size, shards=[mesh.rank])
    return shard_mod.take_shard(sp, 0, mesh.device)


def shard_cm_problem_multihost(cmp, mesh, with_grouped: bool = True):
    """This rank's shard of the global component-major partition and, with
    ``with_grouped``, its kernel operands: ``(ShardedCMProblem, GroupedOps
    or None)`` for :func:`~pysfm_tpu_torch.dist.solve_sharded_cm`."""
    from pysfm_tpu_torch.dist import sharded_cm

    scm = sharded_cm.shard_cm_problem(cmp, mesh.size, shards=[mesh.rank])
    return sharded_cm._put_local(scm, 0, mesh.device, with_grouped)
