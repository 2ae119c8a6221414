"""The pcg route's kernels: normal-equation build (K_E), the coupling rows
alone (K_D), robust cost (K_C), ``Hcp^T x``, ``Hcp w`` and the block-Jacobi
diagonal (K_H), each a CUDA kernel (``csrc/eqs.cu``, ``csrc/spmv.cu``) with
its plain PyTorch version.

Counterpart of ``pysfm_tpu/solver/kernels/pallas_spmv.py``.  The JAX
package re-sorts the observations into a grouped stream
(``problem/grouped.py``, ``permute_b_rows``) because Mosaic's one fast
gather is local to an (8, 128) register.  Here :class:`GroupedOps` is CSR
over the CMProblem's own point-sorted order, with a second, camera-sorted
copy of the rows, so that each CG product streams its rows in order:

- ``pt_ptr [P+1]``: each point's observations are ``pt_ptr[p]:pt_ptr[p+1]``;
- ``cam_perm [M]`` / ``cam_ptr [C+1]``: observation ids stably sorted by
  camera, and each camera's range of them; ``cam_pt = obs_pt[cam_perm]``;
- ``u_cam``, ``v_cam``, ``w_cam [M]``: the measurements camera-sorted
  (``u[cam_perm]``, ...), static, read by K_E's camera pass: 12 B an
  observation, 60 MB at Venice;
- ``b_rows [3*CP, M]``: the per-iteration coupling rows, row ``s*CP + d``,
  point-sorted (exactly ``B_cm``), stored in ``rows_dtype``; ``hcpT_x``
  reads it;
- ``b_cam [3*CP, M]``: the same rows camera-sorted, ``b_cam[:, j] ==
  b_rows[:, cam_perm[j]]`` bit for bit, stored by K_E's camera pass where it
  computes them; ``hcp_w`` and K_H read it.  It costs ``3*CP*M`` more
  elements: 360 MB at Venice (M ~ 5M, CP = 6) in f32, 180 MB in bf16;
- the static plans: ``chunk_off`` / ``chunk_ptr`` cut each camera's range
  into chunks of at most :data:`HCP_W_CHUNK` observations (one block each
  of ``hcp_w``, K_H and K_E's camera pass, then a fixed-order sum per
  camera); ``tile_pt`` cuts the point-sorted stream into tiles of whole
  points, at most :data:`HCPT_X_TILE` observations each, a point whose
  track is longer than half a tile alone (one block each of ``hcpT_x`` and
  K_E's point pass).

The superstep (two-phase) TPU kernels K_A2 / K_B2 compute what K_A / K_B
compute; one kernel here replaces each pair.  Every sum has a fixed order
(no float atomics), so the kernels are bitwise repeatable.

Dispatch is by device, nothing else: for CPU tensors every wrapper runs its
plain version (sums with ``index_add_``, deterministic on the CPU); for CUDA
tensors it launches the kernel (f32 arithmetic, f32 or bf16 rows) or
raises.  :data:`LAUNCHES` counts kernel launches per wrapper.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pysfm_tpu_torch.geometry import projection
from pysfm_tpu_torch.problem import cm
from pysfm_tpu_torch.problem import robust as robust_mod
from pysfm_tpu_torch.solver import scale
from pysfm_tpu_torch.solver.kernels.proj import _MODEL_ID, _ROBUST_ID, _check

# Kernel launches in this process, per wrapper (each adds one per launch).
KERNELS = ("build_eqs", "cost", "hcpT_x", "hcp_w", "precond_diag", "payload_b")
LAUNCHES = dict.fromkeys(KERNELS, 0)

# Observations of one hcp_w chunk (never across a camera), and of one
# hcpT_x tile (whole points; a point with more than half of it is alone).
HCP_W_CHUNK = 1024
HCPT_X_TILE = 1024
# Threads of a cost-kernel block, and the most blocks it runs (it runs one
# per SM at most, grid-stride over the observations).
_COST_BLOCK = 1024
_COST_MAX_BLOCKS = 1024
_BLOCK = 256
# The cost kernel's tickets: an int32 zero per (device, stream), allocated
# at first use.  The kernel's last block sets it back to 0, so one counter
# serves every call on that stream.
_COST_TICKETS: dict = {}


@dataclasses.dataclass(frozen=True)
class GroupedOps:
    """Static CSR layout of one problem's observations and the plans of the
    two CG products, plus the coupling rows of the current linearization
    in both orders (``b_rows``, ``b_cam``; None until built)."""

    obs_cam: torch.Tensor    # [M] int32
    obs_pt: torch.Tensor     # [M] int32, sorted
    pt_ptr: torch.Tensor     # [P+1] int32
    cam_ptr: torch.Tensor    # [C+1] int32
    cam_perm: torch.Tensor   # [M] int32
    cam_pt: torch.Tensor     # [M] int32, obs_pt[cam_perm]
    chunk_off: torch.Tensor  # [n_chunks+1] int32, hcp_w's chunks of cam order
    chunk_ptr: torch.Tensor  # [C+1] int32, each camera's range of chunks
    tile_pt: torch.Tensor    # [n_tiles+1] int32, first point of each hcpT_x tile
    u: torch.Tensor          # [M] measured pixel u
    v: torch.Tensor          # [M] measured pixel v
    w: torch.Tensor          # [M] confidence weight
    u_cam: torch.Tensor      # [M] u[cam_perm]
    v_cam: torch.Tensor      # [M] v[cam_perm]
    w_cam: torch.Tensor      # [M] w[cam_perm]
    rows_dtype: torch.dtype
    b_rows: Optional[torch.Tensor] = None   # [3*CP, M] in rows_dtype, point-sorted
    b_cam: Optional[torch.Tensor] = None    # [3*CP, M] in rows_dtype, camera-sorted

    @property
    def n_cameras(self) -> int:
        return self.cam_ptr.shape[0] - 1

    @property
    def n_points(self) -> int:
        return self.pt_ptr.shape[0] - 1

    @property
    def n_obs(self) -> int:
        return self.obs_cam.shape[0]

    def replace(self, **changes) -> "GroupedOps":
        """A copy with ``changes``.  New ``b_rows`` without ``b_cam`` drop the
        old ``b_cam``, which belongs to another linearization: the ``hcp_w``
        and K_H kernels then raise instead of reading stale rows."""
        if "b_rows" in changes and "b_cam" not in changes:
            changes["b_cam"] = None
        return dataclasses.replace(self, **changes)


def _offsets(ids: torch.Tensor, n: int) -> torch.Tensor:
    counts = torch.bincount(ids.long(), minlength=n)
    ptr = torch.zeros(n + 1, dtype=torch.int64, device=ids.device)
    ptr[1:] = torch.cumsum(counts, 0)
    return ptr.to(torch.int32)


def _chunk_plan(cam_ptr: torch.Tensor, chunk: int):
    """hcp_w's chunks: each camera's range of the camera-sorted observations
    cut into pieces of at most ``chunk``.  Returns ``chunk_off
    [n_chunks+1]`` (chunk i is ``chunk_off[i]:chunk_off[i+1]``) and
    ``chunk_ptr [C+1]`` (camera c owns chunks ``chunk_ptr[c]:chunk_ptr[c+1]``,
    none if it has no observations)."""
    ptr = cam_ptr.long()
    per_cam = (ptr[1:] - ptr[:-1] + chunk - 1) // chunk
    chunk_ptr = torch.zeros_like(ptr)
    chunk_ptr[1:] = torch.cumsum(per_cam, 0)
    cam = torch.repeat_interleave(torch.arange(per_cam.shape[0], device=ptr.device), per_cam)
    k = torch.arange(cam.shape[0], device=ptr.device) - chunk_ptr[cam]
    chunk_off = torch.cat([ptr[cam] + k * chunk, ptr[-1:]])
    return chunk_off.to(torch.int32), chunk_ptr.to(torch.int32)


def _tile_plan(pt_ptr: torch.Tensor, tile: int) -> torch.Tensor:
    """hcpT_x's tiles of the point-sorted stream, as the first point of each
    and ``P`` at the end: a new tile starts where a point's first
    observation enters the next window of ``tile // 2``, and around every
    point whose track is longer than that window, which is alone.  A tile of
    several points therefore spans at most ``tile`` observations."""
    half = tile // 2
    ptr = pt_ptr.long()
    start = ptr[:-1]
    lone = ptr[1:] - start > half
    win = start // half
    new = torch.ones_like(lone)
    new[1:] = (win[1:] != win[:-1]) | lone[1:] | lone[:-1]
    first = torch.nonzero(new).flatten()
    return torch.cat([first, ptr.new_tensor([start.shape[0]])]).to(torch.int32)


def grouped_ops(obs_cam, obs_pt, n_cameras: int, n_points: int, u, v, w,
                rows_dtype) -> GroupedOps:
    """Build the CSR layout and the products' plans on the device of
    ``obs_cam``.  The observations must be sorted by point, as a
    CMProblem's are."""
    M = obs_cam.shape[0]
    if M > 2**31 - _BLOCK:
        raise ValueError(f"M={M} overflows the kernels' int32 observation index")
    if M > 1 and bool((obs_pt[1:] < obs_pt[:-1]).any()):
        raise ValueError("observations must be sorted by point")
    obs_pt = obs_pt.to(torch.int32)
    cam_perm = torch.sort(obs_cam, stable=True).indices.to(torch.int32)
    cam_ptr = _offsets(obs_cam, n_cameras)
    pt_ptr = _offsets(obs_pt, n_points)
    chunk_off, chunk_ptr = _chunk_plan(cam_ptr, HCP_W_CHUNK)
    return GroupedOps(
        obs_cam=obs_cam.to(torch.int32), obs_pt=obs_pt, pt_ptr=pt_ptr,
        cam_ptr=cam_ptr, cam_perm=cam_perm, cam_pt=obs_pt[cam_perm],
        chunk_off=chunk_off, chunk_ptr=chunk_ptr,
        tile_pt=_tile_plan(pt_ptr, HCPT_X_TILE), u=u, v=v, w=w,
        u_cam=u[cam_perm], v_cam=v[cam_perm], w_cam=w[cam_perm],
        rows_dtype=rows_dtype,
    )


def _route(t: torch.Tensor) -> bool:
    """True to launch the kernel (CUDA tensor), False for the plain version
    (CPU tensor); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return True


def _rows(ops: GroupedOps) -> torch.Tensor:
    if ops.b_rows is None:
        raise ValueError("ops.b_rows is not built (GroupedOps.replace(b_rows=...))")
    return ops.b_rows


def _b_cam(ops: GroupedOps, kernel: str) -> torch.Tensor:
    if ops.b_cam is None:
        raise ValueError(f"ops.b_cam is not built: the {kernel} kernel reads the camera-sorted "
                         "rows that build_eqs returns (GroupedOps.replace(b_cam=...))")
    return ops.b_cam


def _check_ops(ops: GroupedOps, dev) -> None:
    M, C, P = ops.n_obs, ops.n_cameras, ops.n_points
    i32, f32 = torch.int32, torch.float32
    for name, shape in (("obs_cam", (M,)), ("obs_pt", (M,)), ("pt_ptr", (P + 1,)),
                        ("cam_ptr", (C + 1,)), ("cam_perm", (M,)), ("cam_pt", (M,)),
                        ("chunk_off", ops.chunk_off.shape), ("chunk_ptr", (C + 1,)),
                        ("tile_pt", ops.tile_pt.shape)):
        _check(name, getattr(ops, name), i32, shape, dev)
    for name in ("u", "v", "w", "u_cam", "v_cam", "w_cam"):
        _check(name, getattr(ops, name), f32, (M,), dev)


def _check_rows(name: str, b: torch.Tensor, cp: int, M: int, dev) -> int:
    """Check coupling rows for a kernel; returns 1 for bf16 rows, 0 for f32."""
    if b.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} is {b.dtype}; the CUDA kernels take f32 or bf16 rows")
    if cp not in (6, 9, 10):
        raise ValueError(f"cp={cp}: the kernels take 6, 9 or 10 camera dof")
    _check(name, b, b.dtype, (3 * cp, M), dev)
    return int(b.dtype == torch.bfloat16)


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    LAUNCHES[name] += 1


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _lib():
    """The kernel library, built at first use (never at import)."""
    from pysfm_tpu_torch.solver.kernels import _build

    return _build.library()


# --------------------------------------------------------------------------
# K_E: normal equations + coupling rows.
# --------------------------------------------------------------------------


def build_eqs_plain(ops: GroupedOps, ctab, X3, robust_scale, *, cp, model,
                    robust, n_cameras, n_points):
    """Plain version of :func:`build_eqs`: the per-observation rows of
    ``scale._payload_rows`` reduced per camera and per point with
    ``index_add_``; the camera-sorted rows are ``B[:, cam_perm]``."""
    B, cam_rows, pt_rows = scale._payload_rows(
        model, robust, robust_scale, ctab, X3, ops.obs_cam, ops.obs_pt,
        ops.u, ops.v, ops.w,
    )
    n_tri = cp * (cp + 1) // 2
    cred = torch.zeros((cam_rows.shape[0], n_cameras), dtype=B.dtype, device=B.device)
    cred.index_add_(1, ops.obs_cam, cam_rows)
    pred = torch.zeros((9, n_points), dtype=B.dtype, device=B.device)
    pred.index_add_(1, ops.obs_pt, pt_rows)
    eqs = scale.ScaleEqs(
        Hcc=scale._unpack_sym(cred[:n_tri], cp), g_c=cred[n_tri:].T.contiguous(),
        hpp6=pred[:6], g_p=pred[6:], B_cm=None,
    )
    b_rows = B.to(ops.rows_dtype)
    return eqs, b_rows, b_rows[:, ops.cam_perm]


def _launch_build_eqs(ops, ctab, X3, robust_scale, cp, model, robust, C, P):
    dev = ctab.device
    f32 = torch.float32
    M = ops.n_obs
    _check_ops(ops, dev)
    _check("ctab", ctab, f32, (13 + projection.INTR_DIM[model], C), dev)
    _check("X3", X3, f32, (3, P), dev)
    _check("robust_scale", robust_scale, f32, (), dev)
    if ops.rows_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rows_dtype {ops.rows_dtype}: the kernel stores f32 or bf16 rows")
    if cp != projection.CAM_DOF[model]:
        raise ValueError(f"cp={cp} is not the {model!r} model's {projection.CAM_DOF[model]}")
    b_rows = torch.empty((3 * cp, M), dtype=ops.rows_dtype, device=dev)
    b_cam = torch.empty_like(b_rows)
    Hcc = torch.empty((C, cp, cp), dtype=f32, device=dev)
    g_c = torch.empty((C, cp), dtype=f32, device=dev)
    hpp6 = torch.empty((6, P), dtype=f32, device=dev)
    g_p = torch.empty((3, P), dtype=f32, device=dev)
    n_chunks = ops.chunk_off.shape[0] - 1
    # The camera pass's per-chunk sums: tri(CP) of Hcc, then CP of g_c.
    partial = torch.empty((cp * (cp + 1) // 2 + cp, n_chunks), dtype=f32, device=dev)
    err = _lib().pysfm_build_eqs(
        _MODEL_ID[model], _ROBUST_ID[robust], int(ops.rows_dtype == torch.bfloat16),
        ctab.data_ptr(), C, X3.data_ptr(), P,
        ops.obs_cam.data_ptr(), ops.obs_pt.data_ptr(), ops.u.data_ptr(),
        ops.v.data_ptr(), ops.w.data_ptr(), ops.pt_ptr.data_ptr(),
        ops.tile_pt.data_ptr(), ops.tile_pt.shape[0] - 1, HCPT_X_TILE,
        ops.cam_perm.data_ptr(), ops.cam_pt.data_ptr(), ops.u_cam.data_ptr(),
        ops.v_cam.data_ptr(), ops.w_cam.data_ptr(), ops.chunk_off.data_ptr(), n_chunks,
        ops.chunk_ptr.data_ptr(), robust_scale.data_ptr(), M, partial.data_ptr(),
        b_rows.data_ptr(), b_cam.data_ptr(), Hcc.data_ptr(), g_c.data_ptr(),
        hpp6.data_ptr(), g_p.data_ptr(), _stream(dev),
    )
    _launched("build_eqs", err)
    eqs = scale.ScaleEqs(Hcc=Hcc, g_c=g_c, hpp6=hpp6, g_p=g_p, B_cm=None)
    return eqs, b_rows, b_cam


def build_eqs(ops: GroupedOps, ctab, X3, robust_scale, *, cp, model, robust,
              n_cameras, n_points):
    """Fused normal-equation build (K_E; JAX ``build_eqs_grouped``):
    residuals, Jacobians and IRLS weights at the parameters in ``ctab``
    (``cm.cam_table``) and ``X3``, reduced to ``ScaleEqs(Hcc, g_c, hpp6,
    g_p, B_cm=None)``, and the coupling rows for the CG products in
    ``ops.rows_dtype`` in both orders: ``(eqs, b_rows, b_cam)``, ``b_rows
    [3*CP, M]`` point-sorted and ``b_cam [3*CP, M]`` camera-sorted
    (``b_cam[:, j] == b_rows[:, cam_perm[j]]`` bit for bit).  The kernel's
    point pass runs one thread per observation over the tiles of
    ``ops.tile_pt``; its camera pass one block per chunk of
    ``ops.chunk_off``, reading the camera-sorted measurements."""
    projection._check_model(model)
    robust_mod._check(robust)
    if not _route(X3):
        return build_eqs_plain(ops, ctab, X3, robust_scale, cp=cp, model=model,
                               robust=robust, n_cameras=n_cameras, n_points=n_points)
    return _launch_build_eqs(ops, ctab, X3, robust_scale, cp, model, robust,
                             n_cameras, n_points)


# --------------------------------------------------------------------------
# K_D: the coupling rows alone.
# --------------------------------------------------------------------------


def payload_b_plain(ops: GroupedOps, ctab, X3, robust_scale, *, cp, model, robust):
    """Plain version of :func:`payload_b`: the B rows of
    ``scale._payload_rows`` in ``ops.rows_dtype`` (the second output of
    :func:`build_eqs_plain`)."""
    B, _, _ = scale._payload_rows(
        model, robust, robust_scale, ctab, X3, ops.obs_cam, ops.obs_pt,
        ops.u, ops.v, ops.w,
    )
    return B.to(ops.rows_dtype)


def payload_b(ops: GroupedOps, ctab, X3, robust_scale, *, cp, model, robust):
    """Coupling rows of the linearization at ``ctab`` / ``X3`` (K_D; JAX
    ``payload_b_grouped``): ``b_rows [3*CP, M]`` in ``ops.rows_dtype``,
    row ``k*CP + d`` = ``w (Jc0d Jp0k + Jc1d Jp1k)``, the ``b_rows`` that
    :func:`build_eqs` returns.  No solve path calls it."""
    projection._check_model(model)
    robust_mod._check(robust)
    if not _route(X3):
        return payload_b_plain(ops, ctab, X3, robust_scale, cp=cp, model=model,
                               robust=robust)
    dev = X3.device
    f32 = torch.float32
    C, P, M = ctab.shape[1], X3.shape[1], ops.n_obs
    _check_ops(ops, dev)
    _check("ctab", ctab, f32, (13 + projection.INTR_DIM[model], C), dev)
    _check("X3", X3, f32, (3, P), dev)
    _check("robust_scale", robust_scale, f32, (), dev)
    if ops.rows_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rows_dtype {ops.rows_dtype}: the kernel stores f32 or bf16 rows")
    if cp != projection.CAM_DOF[model]:
        raise ValueError(f"cp={cp} is not the {model!r} model's {projection.CAM_DOF[model]}")
    b_rows = torch.empty((3 * cp, M), dtype=ops.rows_dtype, device=dev)
    err = _lib().pysfm_payload_b(
        _MODEL_ID[model], _ROBUST_ID[robust], int(ops.rows_dtype == torch.bfloat16),
        ctab.data_ptr(), C, X3.data_ptr(), P, ops.obs_cam.data_ptr(),
        ops.obs_pt.data_ptr(), ops.u.data_ptr(), ops.v.data_ptr(), ops.w.data_ptr(),
        robust_scale.data_ptr(), M, b_rows.data_ptr(), _stream(dev),
    )
    _launched("payload_b", err)
    return b_rows


# --------------------------------------------------------------------------
# K_C: robust cost.
# --------------------------------------------------------------------------


def cost_plain(ops: GroupedOps, ctab, X3, robust_scale, *, model, robust):
    """Plain version of :func:`cost`."""
    uh, vh = cm.project_cm(model, ctab[:, ops.obs_cam], X3[:, ops.obs_pt])
    r0 = uh - ops.u
    r1 = vh - ops.v
    s = r0 * r0 + r1 * r1
    return 0.5 * torch.sum(ops.w * robust_mod.rho(robust, s, robust_scale))


def cost_blocks(M: int) -> int:
    """Double partials the cost kernel may write for M observations (its
    grid, one block of 1024 threads per SM at most, is chosen on the card
    and never exceeds this)."""
    return max(1, min(_COST_MAX_BLOCKS, -(-M // _COST_BLOCK)))


def cost_ticket(device, stream: int) -> torch.Tensor:
    """The cost kernel's ticket counter for ``stream`` on ``device``: an
    int32 ``[1]`` zero, allocated once and reused (the kernel's last block
    resets it); two streams never share one."""
    key = (torch.device(device), stream)
    ticket = _COST_TICKETS.get(key)
    if ticket is None:
        ticket = _COST_TICKETS[key] = torch.zeros((1,), dtype=torch.int32, device=key[0])
    return ticket


def cost(ops: GroupedOps, ctab, X3, robust_scale, *, model, robust):
    """Robust cost ``0.5 sum_m w_m rho(|r_m|^2)`` (K_C; JAX
    ``cost_grouped``), an f32 scalar tensor on the kernel route.  The
    kernel is one launch: per-block double partials added in block order by
    the last block."""
    projection._check_model(model)
    robust_mod._check(robust)
    if not _route(X3):
        return cost_plain(ops, ctab, X3, robust_scale, model=model, robust=robust)
    dev = X3.device
    f32 = torch.float32
    C, P, M = ctab.shape[1], X3.shape[1], ops.n_obs
    _check_ops(ops, dev)
    _check("ctab", ctab, f32, (13 + projection.INTR_DIM[model], C), dev)
    _check("X3", X3, f32, (3, P), dev)
    _check("robust_scale", robust_scale, f32, (), dev)
    n_partial = cost_blocks(M)
    partial = torch.empty((n_partial,), dtype=torch.float64, device=dev)
    out = torch.empty((), dtype=f32, device=dev)
    stream = _stream(dev)
    err = _lib().pysfm_cost(
        _MODEL_ID[model], _ROBUST_ID[robust], ctab.data_ptr(), C, X3.data_ptr(), P,
        ops.obs_cam.data_ptr(), ops.obs_pt.data_ptr(), ops.u.data_ptr(),
        ops.v.data_ptr(), ops.w.data_ptr(), robust_scale.data_ptr(), M,
        partial.data_ptr(), n_partial,
        cost_ticket(dev, stream).data_ptr(), out.data_ptr(), stream,
    )
    _launched("cost", err)
    return out


# --------------------------------------------------------------------------
# Hcp^T x, Hcp w, and the block-Jacobi diagonal (K_H).
# --------------------------------------------------------------------------


def _rows_f(ops: GroupedOps, dtype) -> torch.Tensor:
    """The coupling rows in the arithmetic type (f32 at least)."""
    return _rows(ops).to(torch.promote_types(dtype, torch.float32))


def hcpT_x_plain(ops: GroupedOps, x, *, cp):
    """Plain version of :func:`hcpT_x`."""
    B4 = _rows_f(ops, x.dtype).reshape(3, cp, -1)
    u_m = torch.einsum("sdm,dm->sm", B4, x.to(B4.dtype)[:, ops.obs_cam])
    u = torch.zeros((3, ops.n_points), dtype=B4.dtype, device=B4.device)
    return u.index_add_(1, ops.obs_pt, u_m)


def hcp_w_plain(ops: GroupedOps, w3, n_cameras, *, cp):
    """Plain version of :func:`hcp_w`."""
    B4 = _rows_f(ops, w3.dtype).reshape(3, cp, -1)
    z = torch.einsum("sdm,sm->dm", B4, w3.to(B4.dtype)[:, ops.obs_pt])
    y = torch.zeros((cp, n_cameras), dtype=B4.dtype, device=B4.device)
    return y.index_add_(1, ops.obs_cam, z)


def precond_diag_plain(ops: GroupedOps, hinv6, n_cameras, *, cp):
    """Plain version of :func:`precond_diag`."""
    B0, B1, B2 = _rows_f(ops, hinv6.dtype).reshape(3, cp, -1)
    a, b, c, d, e, f = hinv6.to(B0.dtype)[:, ops.obs_pt]
    BH0 = a * B0 + b * B1 + d * B2
    BH1 = b * B0 + c * B1 + e * B2
    BH2 = d * B0 + e * B1 + f * B2
    D_m = BH0[:, None] * B0[None] + BH1[:, None] * B1[None] + BH2[:, None] * B2[None]
    D = torch.zeros((cp, cp, n_cameras), dtype=B0.dtype, device=B0.device)
    return D.index_add_(2, ops.obs_cam, D_m).permute(2, 0, 1).contiguous()


def hcpT_x(ops: GroupedOps, x, *, cp):
    """``u = Hcp^T x`` (JAX ``hcpT_x_grouped`` / ``hcpT_x_grouped2``):
    ``x [CP, C]`` -> ``u [3, P]``,
    ``u[s, p] = sum_{m of p} sum_d b_rows[s*CP+d, m] x[d, cam(m)]``.  The
    kernel reads ``b_rows`` in order, tile by tile of ``ops.tile_pt``, with
    x in shared memory when it fits."""
    if not _route(x):
        return hcpT_x_plain(ops, x, cp=cp)
    return _launch_hcpT_x(ops, x, cp, None)


def _launch_hcpT_x(ops: GroupedOps, x, cp, x_shared: Optional[bool]):
    """The ``hcpT_x`` kernel with x in shared memory (True; raises where it
    does not fit), gathered from global memory (False), or chosen by size
    (None, as :func:`hcpT_x` does).  Both branches give the same bits."""
    dev = x.device
    C, P, M = ops.n_cameras, ops.n_points, ops.n_obs
    _check_ops(ops, dev)
    b = _rows(ops)
    bf16 = _check_rows("b_rows", b, cp, M, dev)
    _check("hcpT_x input", x, torch.float32, (cp, C), dev)
    u = torch.empty((3, P), dtype=torch.float32, device=dev)
    err = _lib().pysfm_hcpT_x(
        cp, bf16, b.data_ptr(), x.data_ptr(), C, ops.obs_cam.data_ptr(),
        ops.pt_ptr.data_ptr(), P, ops.tile_pt.data_ptr(), ops.tile_pt.shape[0] - 1,
        HCPT_X_TILE, M, -1 if x_shared is None else int(x_shared), u.data_ptr(),
        _stream(dev),
    )
    _launched("hcpT_x", err)
    return u


def hcp_w(ops: GroupedOps, w3, n_cameras, *, cp):
    """``y = Hcp w`` (JAX ``hcp_w_grouped`` / ``hcp_w_grouped2``):
    ``w3 [3, P]`` -> ``y [CP, C]``,
    ``y[d, c] = sum_{m of c} sum_s b_rows[s*CP+d, m] w3[s, pt(m)]``.  The
    kernel reads the camera-sorted ``ops.b_cam`` in order (chunks of
    ``ops.chunk_off``, then a fixed-order sum per camera); without it, it
    raises."""
    if not _route(w3):
        return hcp_w_plain(ops, w3, n_cameras, cp=cp)
    dev = w3.device
    C, P, M = ops.n_cameras, ops.n_points, ops.n_obs
    if n_cameras != C:
        raise ValueError(f"n_cameras={n_cameras}, but the layout has {C} cameras")
    _check_ops(ops, dev)
    b = _b_cam(ops, "hcp_w")
    bf16 = _check_rows("b_cam", b, cp, M, dev)
    _check("hcp_w input", w3, torch.float32, (3, P), dev)
    n_chunks = ops.chunk_off.shape[0] - 1
    partial = torch.empty((cp, n_chunks), dtype=torch.float32, device=dev)
    y = torch.empty((cp, C), dtype=torch.float32, device=dev)
    err = _lib().pysfm_hcp_w(
        cp, bf16, b.data_ptr(), w3.data_ptr(), P, ops.cam_pt.data_ptr(),
        ops.chunk_off.data_ptr(), n_chunks, ops.chunk_ptr.data_ptr(), C, M,
        partial.data_ptr(), y.data_ptr(), _stream(dev),
    )
    _launched("hcp_w", err)
    return y


def precond_diag(ops: GroupedOps, hinv6, n_cameras, *, cp):
    """Block-Jacobi correction (K_H; JAX ``precond_diag_grouped``):
    ``D[c] = sum_{m of c} B_m Hinv[pt(m)] B_m^T`` with ``hinv6 [6, P]``;
    returns ``D [C, CP, CP]``, symmetric.  The kernel reads the
    camera-sorted ``ops.b_cam`` in order, as :func:`hcp_w` does; without
    it, it raises."""
    if not _route(hinv6):
        return precond_diag_plain(ops, hinv6, n_cameras, cp=cp)
    dev = hinv6.device
    C, P, M = ops.n_cameras, ops.n_points, ops.n_obs
    if n_cameras != C:
        raise ValueError(f"n_cameras={n_cameras}, but the layout has {C} cameras")
    _check_ops(ops, dev)
    b = _b_cam(ops, "precond_diag")
    bf16 = _check_rows("b_cam", b, cp, M, dev)
    _check("precond_diag input", hinv6, torch.float32, (6, P), dev)
    n_chunks = ops.chunk_off.shape[0] - 1
    # Scratch: Hinv point-major, one 32-byte sector a point, and the
    # per-chunk sums.
    hinv_pt = torch.empty((P, 8), dtype=torch.float32, device=dev)
    partial = torch.empty((cp * (cp + 1) // 2, n_chunks), dtype=torch.float32, device=dev)
    D = torch.empty((C, cp, cp), dtype=torch.float32, device=dev)
    err = _lib().pysfm_precond_diag(
        cp, bf16, b.data_ptr(), hinv6.data_ptr(), P, hinv_pt.data_ptr(),
        ops.cam_pt.data_ptr(), ops.chunk_off.data_ptr(), n_chunks, ops.chunk_ptr.data_ptr(),
        C, M, partial.data_ptr(), D.data_ptr(), _stream(dev),
    )
    _launched("precond_diag", err)
    return D
