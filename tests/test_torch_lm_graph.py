"""The dense LM loop as one iteration function of tensors
(``lm._iteration``), which the card replays as a CUDA graph, on the CPU.

- The restructured loop against the JAX package's ``_solve_std`` on a small
  scene, f64 and f32, both layouts, with ``renormalize_every=2`` and a
  ``tol_cost_rel`` that stops it at iteration 5 of 12: the logs written at
  the device counter, the renormalization predicate on it, the early stop
  and the forward-filled cost log.  Tolerances: f64 logs within 1e-9
  relative (as ``test_torch_lm.py``: the packages sum in other orders);
  f32 costs and damping within 1e-4 over five iterations, the gradient and
  step norms within 1e-2 (sums that cancel near the optimum); the accept
  decisions and the stop agree exactly.
- The graph cache's key, and which solves take the graph.
- The graphed loop's host side (load, first iteration, replays, the
  clone-out and the cache's eviction) with a stand-in for the CUDA graph
  that runs the iteration at each replay: a CPU run cannot capture, the
  card's ``chip_smoke.py`` [dense graph] holds the real graph to the eager
  loop bit for bit.
"""

import contextlib
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysfm_tpu.geometry import so3 as jso3
from pysfm_tpu.pipeline import synthetic as jsyn
from pysfm_tpu.solver import LMConfig as JLMConfig
from pysfm_tpu.solver.lm import _solve_std as j_solve_std
from pysfm_tpu_torch.geometry import so3 as tso3
from pysfm_tpu_torch.pipeline import synthetic as tsyn
from pysfm_tpu_torch.problem import problem as tprob
from pysfm_tpu_torch.solver import LMConfig, lm, solve

torch.set_num_threads(2)
SCENE = dict(noise_px=0.5, outlier_frac=0.05, outlier_px=40.0,
             robust="huber", robust_scale=2.0, seed=11)
# Relative decreases of this scene's cost: 1.9e-4 at iteration 4, 3.2e-5
# at iteration 5 (f32 and f64 alike), so the loop stops after 5 of 12.
EARLY = dict(max_iters=12, renormalize_every=2, tol_cost_rel=1e-4, tol_grad=0.0,
             tol_step=0.0)
CASES = [(np.float64, "cm"), (np.float32, "cm"), (np.float64, "std")]


def to_port(p):
    arrays = {k: np.asarray(getattr(p, k)) for k in tprob.FIELDS}
    return tprob.from_numpy(arrays, p.camera_model, p.robust, device="cpu")


@pytest.fixture(scope="module")
def jax_runs():
    """{(dtype, layout): (JAX problem, JAX result)}, each solved once."""
    out = {}
    for dtype, layout in CASES:
        p = jsyn.make_scene(6, 300, dtype=dtype, **SCENE).problem
        out[dtype, layout] = p, jax.block_until_ready(
            j_solve_std(p, JLMConfig(layout=layout, **EARLY)))
    return out


@pytest.mark.parametrize("dtype,layout", CASES)
def test_iteration_matches_jax(jax_runs, dtype, layout):
    p, (pj, sj) = jax_runs[dtype, layout]
    pt, st = solve(to_port(p), LMConfig(layout=layout, **EARLY))
    n = int(st.n_iters)
    assert n == int(sj.n_iters) == 5
    rtol = 1e-9 if dtype == np.float64 else 1e-4
    np.testing.assert_allclose(st.costs.numpy(), np.asarray(sj.costs), rtol=rtol)
    assert (st.costs[n:] == st.costs[n]).all()
    np.testing.assert_array_equal(st.accepted.numpy(), np.asarray(sj.accepted))
    # The gradient and the step are sums that cancel as the solve nears its
    # optimum: in f32 their rounding is ~1e-3 of their size by iteration 3.
    rtol_g = 1e-9 if dtype == np.float64 else 1e-2
    for got, want, tol in ((st.lams, sj.lams, rtol), (st.grad_inf, sj.grad_inf, rtol_g),
                           (st.step_norms, sj.step_norms, rtol_g)):
        np.testing.assert_allclose(got[:n].numpy(), np.asarray(want)[:n], rtol=tol)
        assert torch.isnan(got[n:]).all() and np.isnan(np.asarray(want)[n:]).all()
    np.testing.assert_allclose(float(st.lam_next), float(sj.lam_next), rtol=rtol)
    np.testing.assert_allclose(float(st.nu_next), float(sj.nu_next), rtol=rtol)
    atol = 1e-9 if dtype == np.float64 else 1e-4
    np.testing.assert_allclose(pt.R.numpy(), np.asarray(pj.R), rtol=rtol, atol=atol)
    np.testing.assert_allclose(pt.X.numpy(), np.asarray(pj.X), rtol=rtol, atol=atol)
    # Iteration 3 (it % 2 == 1) renormalized: R is orthonormal to rounding.
    eye = torch.eye(3, dtype=pt.R.dtype)
    err = (pt.R.transpose(1, 2) @ pt.R - eye).abs().max()
    assert err < 50 * torch.finfo(pt.R.dtype).eps


@pytest.mark.parametrize("eps", [1e-7, 1e-4, 1e-2])
def test_normalize_near_matches_jax_normalize(eps):
    """The loop's SVD-free renormalization equals the JAX package's SVD one
    on near-rotations, to f64 rounding."""
    rng = np.random.default_rng(3)
    R = np.asarray(jso3.exp(jnp.asarray(rng.normal(size=(32, 3)))))
    R_noisy = R + eps * rng.normal(size=R.shape)
    np.testing.assert_allclose(tso3.normalize_near(torch.from_numpy(R_noisy)).numpy(),
                               np.asarray(jso3.normalize(jnp.asarray(R_noisy))),
                               rtol=0, atol=1e-13)


def _scene(seed=11, n=6, dtype=np.float64, **kw):
    return tsyn.make_scene(n, 300, dtype=dtype, device="cpu",
                           **{**SCENE, "seed": seed, **kw}).problem


def test_graph_key():
    """The key holds what a capture bakes in and nothing of the values."""
    cfg = LMConfig(**EARLY)
    key = lm._graph_key(_scene(), cfg)
    assert lm._graph_key(_scene(seed=12), cfg) == key  # other data, same shapes
    others = [
        lm._graph_key(_scene(n=7), cfg),
        lm._graph_key(_scene(dtype=np.float32), cfg),
        lm._graph_key(_scene(camera_model="bal"), cfg),
        lm._graph_key(_scene(robust="cauchy"), cfg),
        lm._graph_key(_scene(), dataclasses.replace(cfg, layout="std")),
        lm._graph_key(_scene(), dataclasses.replace(cfg, lam_max=1e8)),
        lm._graph_key(_scene(), dataclasses.replace(cfg, max_iters=13)),
    ]
    assert all(k != key for k in others)
    assert len(set(others)) == len(others)


def test_cpu_and_group_take_the_eager_loop(monkeypatch):
    """CPU problems and ``group=`` run the eager loop; a CUDA problem
    without a group runs the graphed one (a CPU run sees only which)."""
    calls = []
    monkeypatch.setattr(lm, "_solve_std_graphed", lambda *a: calls.append("graph"))
    monkeypatch.setattr(lm, "_solve_std_eager", lambda *a: calls.append("eager"))
    cfg = LMConfig(**EARLY)
    lm._solve_std(_scene(), cfg)
    lm._solve_std(_scene(), cfg, group=object())
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0))
    lm._solve_std(on_card, cfg, group=object())
    lm._solve_std(on_card, cfg)
    lm._solve_std(on_card, dataclasses.replace(cfg, max_iters=0))
    assert calls == ["eager", "eager", "eager", "graph", "eager"]


@pytest.fixture
def stand_in_graph(monkeypatch):
    """``_DenseGraph`` with its capture replaced: the first iteration runs
    as on the card, and each replay runs the iteration again on the static
    tensors (what the captured graph does); no CUDA device to switch to."""
    def first_and_capture(self):
        self._advance()
        self.graph = types.SimpleNamespace(replay=self._advance)

    monkeypatch.setattr(lm._DenseGraph, "first_and_capture", first_and_capture)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(lm, "_GRAPHS", type(lm._GRAPHS)())
    monkeypatch.setattr(lm, "GRAPH_CACHE_SIZE", 2)


def _same(a, b):
    (pa, sa), (pb, sb) = a, b
    for x, y in [(getattr(pa, k), getattr(pb, k)) for k in ("R", "t", "intr", "X")] + [
            (getattr(sa, f.name), getattr(sb, f.name)) for f in dataclasses.fields(sa)]:
        assert torch.equal(torch.nan_to_num(x, 7.0) if x.is_floating_point() else x,
                           torch.nan_to_num(y, 7.0) if y.is_floating_point() else y)


@pytest.mark.parametrize("layout", ["cm", "std"])
def test_graphed_host_side_equals_eager(stand_in_graph, layout):
    """Two same-shape problems back to back each equal their own eager
    solve (no stale static input), the first result is unchanged by the
    second solve (no aliasing), and an early stop with renormalization
    stops where the eager loop stops; a third key evicts the oldest."""
    cfg = LMConfig(layout=layout, **EARLY)
    a, b = _scene(seed=11), _scene(seed=12)
    ra = lm._solve_std_graphed(a, cfg)
    kept = (ra[0].R.clone(), ra[1].costs.clone())
    rb = lm._solve_std_graphed(b, cfg)
    assert len(lm._GRAPHS) == 1
    _same(ra, lm._solve_std_eager(a, cfg))
    _same(rb, lm._solve_std_eager(b, cfg))
    assert torch.equal(ra[0].R, kept[0]) and torch.equal(ra[1].costs, kept[1])
    assert int(ra[1].n_iters) == 5
    _same(lm._solve_std_graphed(a, cfg, 1e-3, 4.0), lm._solve_std_eager(a, cfg, 1e-3, 4.0))
    full = dataclasses.replace(cfg, tol_cost_rel=0.0, max_iters=6)
    _same(lm._solve_std_graphed(a, full), lm._solve_std_eager(a, full))
    lm._solve_std_graphed(a, dataclasses.replace(full, max_iters=3))
    assert len(lm._GRAPHS) == 2 and lm._graph_key(a, cfg) not in lm._GRAPHS
