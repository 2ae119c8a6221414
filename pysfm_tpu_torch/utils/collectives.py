"""The JAX collectives over the mesh axis, on ``torch.distributed``.

Every call site of the distributed solver reads like the JAX line it ports:

=====================  ==================================================
JAX                    here
=====================  ==================================================
``psum``               :func:`psum`: ``all_reduce(SUM)``
``pmax``               :func:`pmax`: ``all_reduce(MAX)``
``psum_scatter``       :func:`psum_scatter`: ``reduce_scatter_tensor``
(``tiled=True``)       over the padded ``[n * n_local, ...]`` layout
``all_gather``         :func:`all_gather`: ``all_gather_into_tensor``
(``tiled=True``)
``axis_index``         ``mesh.rank``
=====================  ==================================================

``mesh`` is a :class:`pysfm_tpu_torch.dist.mesh.Mesh` (the collectives run
over the default, world, group) or None.  Each function returns a new
tensor and leaves its operand as it was (JAX's collectives are pure).  With
``mesh=None`` each returns its operand itself: the single-device path
launches nothing more.  :func:`psum_many` sums several tensors in one
``all_reduce``.

This module sits below ``solver/`` and ``dist/``, which both import it.

The gloo backend has ``all_reduce`` for CPU and CUDA tensors but not, in
every PyTorch release, ``reduce_scatter`` and ``all_gather_into_tensor``
for CUDA tensors.  So for gloo with CUDA tensors the two are built from
``all_reduce`` (:func:`_scatter_by_all_reduce`,
:func:`_gather_by_all_reduce`): the gather as the sum of zero-filled
blocks, exact, and the scatter as a full sum of which each rank keeps its
own rows.  CPU tensors over gloo and every tensor over NCCL take the native
collectives.

:data:`CALLS` and :data:`BYTES` count, per collective, the calls and the
bytes of the operands handed to it (the payload, not the backend's wire
protocol) in this process.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as tdist

CALLS = dict.fromkeys(("psum", "pmax", "psum_scatter", "all_gather"), 0)
BYTES = dict.fromkeys(CALLS, 0)


def reset_counts() -> None:
    for k in CALLS:
        CALLS[k] = 0
        BYTES[k] = 0


def _count(name: str, x: torch.Tensor) -> None:
    CALLS[name] += 1
    BYTES[name] += x.numel() * x.element_size()


def psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum over the ranks (``jax.lax.psum``)."""
    if mesh is None:
        return x
    _count("psum", x)
    y = x.clone(memory_format=torch.contiguous_format)
    tdist.all_reduce(y, op=tdist.ReduceOp.SUM)
    return y


def psum_many(xs: Sequence[torch.Tensor], mesh) -> Tuple[torch.Tensor, ...]:
    """:func:`psum` of each of ``xs`` (one dtype and device) in one
    ``all_reduce`` of their concatenation."""
    if mesh is None:
        return tuple(xs)
    flat = psum(torch.cat([x.reshape(-1) for x in xs]), mesh)
    return tuple(f.view_as(x) for f, x in zip(flat.split([x.numel() for x in xs]), xs))


def pmax(x: torch.Tensor, mesh) -> torch.Tensor:
    """Maximum over the ranks (``jax.lax.pmax``)."""
    if mesh is None:
        return x
    _count("pmax", x)
    y = x.clone(memory_format=torch.contiguous_format)
    tdist.all_reduce(y, op=tdist.ReduceOp.MAX)
    return y


def _staged(x: torch.Tensor, mesh) -> bool:
    """gloo with a CUDA tensor: the two collectives gloo may lack."""
    return mesh.backend == "gloo" and x.is_cuda


def _scatter_by_all_reduce(x0: torch.Tensor, mesh) -> torch.Tensor:
    """gloo, CUDA tensors: the sum over the ranks of ``x0 [n * k, ...]``,
    of which this rank keeps rows ``[rank * k, (rank + 1) * k)``."""
    y = x0.clone()
    tdist.all_reduce(y, op=tdist.ReduceOp.SUM)
    k = x0.shape[0] // mesh.size
    return y[mesh.rank * k:(mesh.rank + 1) * k].contiguous()


def _gather_by_all_reduce(x0: torch.Tensor, mesh) -> torch.Tensor:
    """gloo, CUDA tensors: ``x0 [k, ...]`` of every rank, stacked in rank
    order, as the sum of zero-filled ``[n * k, ...]`` tensors (exact: each
    entry is one rank's value plus zeros)."""
    k = x0.shape[0]
    y = x0.new_zeros((mesh.size * k,) + tuple(x0.shape[1:]))
    y[mesh.rank * k:(mesh.rank + 1) * k] = x0
    tdist.all_reduce(y, op=tdist.ReduceOp.SUM)
    return y


def psum_scatter(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``:
    the sum over the ranks, cut along ``dim`` (of size ``n * k``) into n
    blocks of k, of which rank r keeps block r."""
    if mesh is None:
        return x
    if x.shape[dim] % mesh.size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {mesh.size} ranks")
    _count("psum_scatter", x)
    x0 = x.movedim(dim, 0).contiguous()
    if _staged(x0, mesh):
        out = _scatter_by_all_reduce(x0, mesh)
    else:
        out = x0.new_empty((x0.shape[0] // mesh.size,) + tuple(x0.shape[1:]))
        tdist.reduce_scatter_tensor(out, x0, op=tdist.ReduceOp.SUM)
    return out.movedim(0, dim).contiguous()


def all_gather(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``: every rank's
    ``x`` concatenated along ``dim`` in rank order."""
    if mesh is None:
        return x
    _count("all_gather", x)
    x0 = x.movedim(dim, 0).contiguous()
    if _staged(x0, mesh):
        out = _gather_by_all_reduce(x0, mesh)
    else:
        out = x0.new_empty((mesh.size * x0.shape[0],) + tuple(x0.shape[1:]))
        tdist.all_gather_into_tensor(out, x0)
    return out.movedim(0, dim).contiguous()
