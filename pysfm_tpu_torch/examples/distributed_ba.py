"""Distributed bundle adjustment over a process group.

Counterpart of the JAX package's ``examples/distributed_ba.py``.  Points
(with their observations) and the camera axis of the reduced solve are
sharded over the ranks; each rank runs the single-device ``cm_lm_loop``
with its sums taken over the group, so every rank takes the same
accept / reject sequence.  The run asserts its own criterion: the
distributed cost trajectory deviates from the single-device one by less
than 1e-4 relative.

Run (N ranks, one process each):

    python -m pysfm_tpu_torch.examples.distributed_ba --nproc 2 --device cpu
    python -m pysfm_tpu_torch.examples.distributed_ba --nproc 1   # NCCL, cuda:0

With ``--device cuda`` rank r uses ``cuda:r`` over NCCL, which needs N
cards.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pysfm_tpu_torch.examples import parser, require_device

SCENE = dict(n_cameras=24, n_points=3000, noise_px=0.5, visibility=0.35, seed=5)
RTOL = 1e-4


def _config():
    from pysfm_tpu_torch.solver import LMConfig

    return LMConfig(max_iters=10, solver="pcg", cg_iters=25, cg_tol=1e-2,
                    tol_grad=0.0, tol_cost_rel=0.0, tol_step=0.0)


def _problem(device, dtype_name):
    from pysfm_tpu_torch.pipeline import synthetic
    from pysfm_tpu_torch.problem import cm

    return cm.from_problem(synthetic.make_scene(**SCENE, dtype=np.dtype(dtype_name),
                                                device=device).problem)


def rank_main(mesh, dtype_name="float32"):
    """One rank: shard, solve with the camera axis partitioned, gather."""
    from pysfm_tpu_torch import dist

    if mesh.device.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // mesh.size))
    cmp = _problem(mesh.device, dtype_name)
    scm, _ = dist.device_put_sharded_cm(dist.shard_cm_problem(cmp, mesh.size), mesh,
                                        with_grouped=False)
    out, st = dist.solve_sharded_cm(scm, None, mesh, _config(), cam_axis=True)
    solved = dist.unshard_cm(out, cmp, mesh)
    if solved.X3.shape != cmp.X3.shape:
        raise AssertionError(f"gathered X3 {tuple(solved.X3.shape)} != {tuple(cmp.X3.shape)}")
    return st.costs.cpu().numpy()


def run(nproc: int = 2, device="cuda", dtype=np.float32, timeout: float = 300.0) -> dict:
    """Solve on ``nproc`` ranks (``cuda:r`` over NCCL, or the CPU over gloo)
    and once on one device; returns both cost logs and the largest relative
    deviation between them."""
    from pysfm_tpu_torch.dist import launch
    from pysfm_tpu_torch.solver import solve

    dev = require_device(device)
    name = np.dtype(dtype).name
    per_rank = launch.spawn(rank_main, nproc, args=(name,),
                            device="cpu" if dev.type == "cpu" else None, timeout=timeout)
    cd = per_rank[0]
    if any(not np.array_equal(c, cd) for c in per_rank):
        raise AssertionError("the ranks' cost logs differ")
    # Single-device reference: the same control flow and trajectory.
    _, st = solve(_problem(dev, name), _config())
    cs = st.costs.cpu().numpy()
    rel = float(np.max(np.abs(cd - cs) / np.maximum(np.abs(cs), 1.0)))
    return dict(costs=cd, costs_single=cs, rel=rel)


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    out = run(args.nproc, args.device, timeout=args.timeout)
    cd, rel = out["costs"], out["rel"]
    print(f"cost {cd[0]:.1f} -> {cd[-1]:.4f} on {args.nproc} ranks ({args.device}); "
          f"max rel deviation vs single-device trajectory {rel:.2e}")
    if not rel < RTOL:
        raise AssertionError(f"deviation {rel:.2e} >= {RTOL}")
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
