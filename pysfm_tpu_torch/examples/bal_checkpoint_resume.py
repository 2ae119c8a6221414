"""BAL text I/O -> pcg solve -> mid-BA checkpoint -> exact resume.

Counterpart of the JAX package's ``examples/bal_checkpoint_resume.py``: a
synthetic stand-in for a BAL dataset is written and read back through the
BAL text format (``io/native.py``'s C++ tokenizer where g++ built it, NumPy
otherwise), solved for 8 iterations on the component-major pcg route
(matrix-free PCG with Eisenstat-Walker forcing), checkpointed with the LM
state (lambda, nu) in the JAX package's file format, loaded, and resumed
for 8 more with the CG warm start (``dc_init``).  The run asserts the
script's own criterion: the resumed final cost within 1e-4 relative of 16
uninterrupted iterations.

On the card an f32 problem takes the pcg kernels (``make_grouped_ops``:
K_E, K_C, ``hcpT_x``, ``hcp_w``, K_H) in all three solves, as the JAX
script's docstring advises on the accelerator; ``run(grouped=False)`` is
the JAX script's literal route (no kernel).

Run:

    python -m pysfm_tpu_torch.examples.bal_checkpoint_resume                # the card
    python -m pysfm_tpu_torch.examples.bal_checkpoint_resume --device cpu
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np

from pysfm_tpu_torch.examples import parser, require_device
from pysfm_tpu_torch.io import bal, checkpoint
from pysfm_tpu_torch.problem import cm
from pysfm_tpu_torch.solver import LMConfig, solve
from pysfm_tpu_torch.solver.lm import make_grouped_ops

SCENE = dict(n_cameras=30, n_points=2000, noise_px=0.5, visibility=0.4, seed=7)
HALF = 8
RTOL = 1e-4
CONFIG = LMConfig(max_iters=HALF, solver="pcg", cg_iters=25, cg_tol=1e-2, cg_forcing="ew",
                  cg_q_tol=0.3, tol_grad=0.0, tol_cost_rel=0.0, tol_step=0.0)


def run(device="cuda", dtype=np.float32, grouped=None) -> dict:
    """Save, load, solve ``HALF`` iterations, checkpoint, resume ``HALF``
    more, and solve ``2 * HALF`` uninterrupted, on ``device`` in ``dtype``.
    ``grouped=None`` takes the kernels for an f32 problem on the card.
    Returns the loaded problem, the three solves' configs and stats, and
    what the script prints."""
    dev = require_device(device)
    if grouped is None:
        grouped = dev.type == "cuda" and np.dtype(dtype) == np.float32

    def gops(cmp):
        return make_grouped_ops(cmp) if grouped else None

    cfg = CONFIG
    with tempfile.TemporaryDirectory(prefix="pysfm_bal_") as tmp:
        path = os.path.join(tmp, "problem.txt")
        _, perturbed = bal.make_synthetic_bal(**SCENE, dtype=dtype, device=dev)
        bal.save_bal(path, perturbed)
        prob = bal.load_bal(path, dtype=dtype, device=dev)
        cmp = cm.from_problem(prob)
        half, st = solve(cmp, cfg, gops=gops(cmp))
        ck = os.path.join(tmp, "ba_state")
        checkpoint.save_checkpoint_cm(ck, half, lam=float(st.lam_next), nu=float(st.nu_next),
                                      iteration=int(st.n_iters))
        # Resume: a fresh process would do exactly this.
        loaded, lam, nu, iteration = checkpoint.load_checkpoint_cm(ck, device=dev)
        _, st_resumed = solve(loaded, cfg, lam_init=lam, nu_init=nu, gops=gops(loaded),
                              dc_init=st.dc_next)
    # Reference: 2 * HALF uninterrupted iterations on the same problem.
    cmp_full = cm.from_problem(prob)
    cfg_full = dataclasses.replace(cfg, max_iters=2 * HALF)
    _, st_full = solve(cmp_full, cfg_full, gops=gops(cmp_full))
    return dict(problem=prob, config=cfg, config_full=cfg_full, grouped=grouped, stats=st,
                stats_resumed=st_resumed, stats_full=st_full, iteration=iteration,
                n_cameras=prob.n_cameras, n_points=prob.n_points, n_obs=prob.n_obs,
                cost0=float(st.costs[0]), c_resumed=float(st_resumed.costs[-1]),
                c_full=float(st_full.costs[-1]))


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    out = run(args.device)
    print(f"loaded {out['n_cameras']} cams / {out['n_points']} pts / {out['n_obs']} obs "
          f"through the BAL text format ({args.device}, kernels: {out['grouped']})")
    c_resumed, c_full = out["c_resumed"], out["c_full"]
    print(f"cost {out['cost0']:.1f} -> {c_resumed:.4f} resumed across a checkpoint vs "
          f"{c_full:.4f} uninterrupted")
    if not abs(c_resumed - c_full) <= RTOL * abs(c_full):
        raise AssertionError(f"resumed {c_resumed} vs uninterrupted {c_full} (rtol {RTOL})")
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
