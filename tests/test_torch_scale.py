"""The pcg route's plain build (``solver/scale.py``) against the JAX
package's on the same CMProblem, in f64: rtol/atol 1e-10 (the two sum the
same products in other orders).  ``obs_chunk=0`` chunks as the JAX code
does (2^18 observations), checked on a port-only problem just above 2^18.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysfm_tpu.pipeline import synthetic as jsyn
from pysfm_tpu.solver import scale as jscale
from pysfm_tpu_torch.problem import cm as tcm
from pysfm_tpu_torch.solver import scale as tscale

torch.set_num_threads(2)
TOL = dict(rtol=1e-10, atol=1e-10)


def _close(a, b):
    np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def _problems(model, robust, seed=5):
    jp = jsyn.make_bal_scene(
        6, 400, mean_track=4.0, max_track=8, camera_model=model, noise_px=0.5,
        outlier_frac=0.05, robust=robust, robust_scale=2.0, seed=seed,
        dtype=np.float64, with_truth=False, layout="cm",
    ).problem
    arrays = {k: np.asarray(getattr(jp, k)) for k in tcm.FIELDS}
    return jp, tcm.from_numpy(arrays, model, robust, device="cpu")


@pytest.mark.parametrize("model,robust", [
    ("pose", "huber"), ("pose_k", "cauchy"), ("bal", "gaussian"),
])
@pytest.mark.parametrize("obs_chunk", [0, 500])
def test_normal_equations_and_cost_match(model, robust, obs_chunk):
    jp, tp = _problems(model, robust)
    je = jscale.build_normal_equations_scale_cm(jp, obs_chunk)
    te = tscale.build_normal_equations_scale_cm(tp, obs_chunk)
    for name in jscale.ScaleEqs._fields:
        _close(getattr(je, name), getattr(te, name))
    _close(jscale.cost_scale_cm(jp, obs_chunk), tscale.cost_scale_cm(tp, obs_chunk))

    rng = np.random.default_rng(2)
    dc = rng.normal(size=(tp.n_cameras, tp.cam_dof))
    dc[0] = 0.0
    dp3 = rng.normal(size=(3, tp.n_points))
    lam = 1e-3
    _close(
        jscale.predicted_reduction_scale_cm(je, jnp.float64(lam), jnp.asarray(dc), jnp.asarray(dp3)),
        tscale.predicted_reduction_scale_cm(
            te, torch.tensor(lam, dtype=torch.float64), torch.from_numpy(dc), torch.from_numpy(dp3)),
    )


def test_point_block_helpers_match(rng):
    A = rng.normal(size=(3, 3, 50))
    H = np.einsum("ikp,jkp->ijp", A, A) + 0.1 * np.eye(3)[..., None]
    h6 = np.stack([H[a, b] for a, b in jscale.TRI3])
    h6[:, :4] = 0.0  # unobserved points: unit fill under augment6
    v = rng.normal(size=(3, 50))
    for lam in (0.0, 1e-2):
        aj = jscale.augment6(jnp.asarray(h6), lam)
        at = tscale.augment6(torch.from_numpy(h6), lam)
        _close(aj, at)
        _close(jscale.sym6_inv(aj), tscale.sym6_inv(at))
        _close(jscale.sym6_mv(aj, jnp.asarray(v)), tscale.sym6_mv(at, torch.from_numpy(v)))
    assert tscale.TRI3 == jscale.TRI3
    assert tscale._tri_pairs(9) == jscale._tri_pairs(9)


@pytest.mark.parametrize("M,obs_chunk,sizes", [
    ((1 << 18) + 5, 0, [1 << 18, 5]),
    (3 * (1 << 18), 0, [1 << 18] * 3),
    (1000, 0, [1000]),
    (1000, 300, [300, 300, 300, 100]),
    (1000, 5000, [1000]),
])
def test_chunks_follow_the_jax_code(M, obs_chunk, sizes):
    """``_chunks`` covers [0, M) in order; 0 means chunks of 2^18 capped at
    M (``pysfm_tpu/solver/scale.py``: ``min(obs_chunk or (1 << 18), M)``)."""
    chunks = tscale._chunks(M, obs_chunk)
    assert [hi - lo for lo, hi in chunks] == sizes
    assert chunks[0][0] == 0 and chunks[-1][1] == M
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))


def test_obs_chunk_zero_bounds_the_working_set(monkeypatch):
    """Above 2^18 observations the plain route at ``obs_chunk=0`` builds no
    per-observation intermediate wider than 2^18 and equals the explicit
    ``obs_chunk=1 << 18`` build within 1e-12 (f64, torch CPU)."""
    from pysfm_tpu_torch.pipeline import synthetic as tsyn

    p = tsyn.make_bal_scene(
        24, 57_000, mean_track=5.0, max_track=8, noise_px=0.5, outlier_frac=0.05,
        robust="huber", robust_scale=2.0, seed=7, dtype=np.float64, with_truth=False,
        layout="cm", device="cpu",
    ).problem
    assert (1 << 18) < p.n_obs < (1 << 18) + 20_000
    widths = []
    payload, project = tscale._payload_rows, tcm.project_cm

    def payload_spy(*a, **k):
        widths.append(a[5].shape[0])    # obs_cam of the chunk
        return payload(*a, **k)

    def project_spy(model, ctab_g, X3_g):
        widths.append(X3_g.shape[1])
        return project(model, ctab_g, X3_g)

    monkeypatch.setattr(tscale, "_payload_rows", payload_spy)
    monkeypatch.setattr(tscale.cm, "project_cm", project_spy)
    e0 = tscale.build_normal_equations_scale_cm(p, 0)
    c0 = tscale.cost_scale_cm(p, 0)
    assert widths == [1 << 18, p.n_obs - (1 << 18)] * 2
    e1 = tscale.build_normal_equations_scale_cm(p, 1 << 18)
    c1 = tscale.cost_scale_cm(p, 1 << 18)
    tight = dict(rtol=1e-12, atol=1e-12)
    for name in tscale.ScaleEqs._fields:
        np.testing.assert_allclose(getattr(e0, name).numpy(), getattr(e1, name).numpy(),
                                   **tight)
    np.testing.assert_allclose(c0.numpy(), c1.numpy(), **tight)
