"""The port's front end (``frontend/``) against the JAX package's on the
same numpy inputs, in f64 on the CPU: the inputs of ``test_frontend.py``.

Tolerances (absolute unless said): 1e-10 for triangulation, depths,
point refinement, Hartley normalization, Sampson distances, the Harris
response and the descriptors (closed forms summed in other orders); E and
F up to sign 1e-9 after normalising to unit Frobenius norm (two SVDs);
quartic roots 1e-9 on the valid slots, with the same valid mask; P3P poses
1e-8; RANSAC given the JAX-drawn minimal sets: the same winning hypothesis
and inlier mask, R and t within 1e-8.  Keypoints are compared as sets of
pixels (``topk`` promises no order among equal scores).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysfm_tpu.frontend import epipolar as jep
from pysfm_tpu.frontend import features as jfeat
from pysfm_tpu.frontend import match as jmatch
from pysfm_tpu.frontend import p3p as jp3p
from pysfm_tpu.frontend import pnp as jpnp
from pysfm_tpu.frontend import ransac as jransac
from pysfm_tpu.frontend import triangulate as jtri
from pysfm_tpu.geometry import so3 as jso3
from pysfm_tpu.pipeline import synthetic as jsyn
from pysfm_tpu_torch.frontend import epipolar, features, match, p3p, pnp, ransac, triangulate

torch.set_num_threads(2)


def T(a):
    return torch.as_tensor(np.array(a))


def N(a):
    return np.asarray(a)


def _draw_row(key, w, n_hypotheses, k):
    """The minimal sets the JAX RANSACs draw from ``key``: one key per
    hypothesis, ``jax.random.choice`` without replacement on w / sum(w)."""
    def one(kh):
        return jax.random.choice(kh, w.shape[0], shape=(k,), replace=False,
                                 p=w / jnp.sum(w))

    return jax.vmap(one)(jax.random.split(key, n_hypotheses))


jax_draws = jax.jit(_draw_row, static_argnums=(2, 3))


def unit_up_to_sign(E):
    E = np.asarray(E) / np.linalg.norm(np.asarray(E))
    return E * np.sign(E.flat[np.argmax(np.abs(E))])


def two_view(rng, n=60, noise=0.0):
    """test_frontend._two_view: ground-truth relative pose + normalized
    correspondences."""
    X = rng.uniform(-2, 2, size=(n, 3)) + np.array([0, 0, 6.0])
    R2 = N(jso3.exp(jnp.asarray(rng.normal(size=3) * 0.3)))
    t2 = np.array([1.0, 0.1, -0.2])
    pn1 = X[:, :2] / X[:, 2:]
    p2 = X @ R2.T + t2
    pn2 = p2[:, :2] / p2[:, 2:]
    if noise:
        pn1 = pn1 + rng.normal(scale=noise, size=pn1.shape)
        pn2 = pn2 + rng.normal(scale=noise, size=pn2.shape)
    return X, R2, t2, pn1, pn2


def scene_table(model, n_cams, n_pts, noise, seed):
    p = jsyn.make_scene(n_cams, n_pts, camera_model=model, noise_px=noise, seed=seed).truth
    uv = np.zeros((p.n_points, p.n_cameras, 2))
    mask = np.zeros((p.n_points, p.n_cameras))
    oc, op = N(p.obs_cam), N(p.obs_pt)
    uv[op, oc] = N(p.obs_uv)
    mask[op, oc] = 1.0
    return p, uv, mask


@pytest.mark.parametrize("model", ["pose", "bal"])
def test_triangulate_matches_jax(model):
    p, uv, mask = scene_table(model, 4, 30, 1.0, 9)
    pn_j = jax.jit(partial(jtri.pixel_to_normalized, model))(p.intr, jnp.asarray(uv))
    pn_t = triangulate.pixel_to_normalized(model, T(p.intr), T(uv))
    np.testing.assert_allclose(pn_t.numpy(), N(pn_j), rtol=0, atol=1e-10)
    Xj = jax.jit(partial(jtri.triangulate_points, model))(
        p.R, p.t, p.intr, jnp.asarray(uv), jnp.asarray(mask))
    Xt = triangulate.triangulate_points(model, T(p.R), T(p.t), T(p.intr), T(uv), T(mask))
    np.testing.assert_allclose(Xt.numpy(), N(Xj), rtol=0, atol=1e-10)
    zj = jtri.depths(p.R[:, None], p.t[:, None], Xj[None])
    zt = triangulate.depths(T(p.R)[:, None], T(p.t)[:, None], Xt[None])
    np.testing.assert_allclose(zt.numpy(), N(zj), rtol=0, atol=1e-10)
    assert triangulate.forward_sign(model) == jtri.forward_sign(model)
    if model == "pose":
        Rj = jax.jit(partial(jtri.refine_points, model))(
            p.R, p.t, p.intr, jnp.asarray(uv), jnp.asarray(mask), Xj)
        Rt = triangulate.refine_points(model, T(p.R), T(p.t), T(p.intr), T(uv), T(mask), Xt)
        np.testing.assert_allclose(Rt.numpy(), N(Rj), rtol=0, atol=1e-10)


def test_epipolar_matches_jax(rng):
    X, R2, t2, pn1, pn2 = two_view(rng, noise=1e-3)
    w = (rng.random(60) < 0.8).astype(np.float64)
    xh_j, T_j = jep.normalize_points(jnp.asarray(pn1), jnp.asarray(w))
    xh_t, T_t = epipolar.normalize_points(T(pn1), T(w))
    np.testing.assert_allclose(xh_t.numpy(), N(xh_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose(T_t.numpy(), N(T_j), rtol=0, atol=1e-10)
    for essential in (False, True):
        Ej = jax.jit(partial(jep.eight_point, essential=essential))(
            jnp.asarray(pn1), jnp.asarray(pn2), jnp.asarray(w))
        Et = epipolar.eight_point(T(pn1), T(pn2), w=T(w), essential=essential)
        np.testing.assert_allclose(unit_up_to_sign(Et), unit_up_to_sign(Ej), rtol=0, atol=1e-9)
        np.testing.assert_allclose(
            epipolar.sampson_distance(Et, T(pn1), T(pn2)).numpy(),
            N(jep.sampson_distance(jnp.asarray(N(Et)), jnp.asarray(pn1), jnp.asarray(pn2))),
            rtol=0, atol=1e-10)
    # The candidates as a set (their slots depend on the SVD's signs), and
    # the same winner by cheirality.
    Rs_j, ts_j = jep.decompose_essential(Ej)
    Rs_t, ts_t = epipolar.decompose_essential(T(N(Ej)))
    cj = {tuple(np.round(np.r_[N(R).ravel(), N(t)], 9)) for R, t in zip(Rs_j, ts_j)}
    ct = {tuple(np.round(np.r_[R.numpy().ravel(), t.numpy()], 9)) for R, t in zip(Rs_t, ts_t)}
    assert cj == ct
    Rj, tj, nj, Xj = jax.jit(jep.select_pose)(Ej, jnp.asarray(pn1), jnp.asarray(pn2),
                                              jnp.asarray(w))
    Rt, tt, nt, Xt = epipolar.select_pose(T(N(Ej)), T(pn1), T(pn2), w=T(w))
    assert float(nt) == float(nj)
    np.testing.assert_allclose(Rt.numpy(), N(Rj), rtol=0, atol=1e-9)
    np.testing.assert_allclose(tt.numpy(), N(tj), rtol=0, atol=1e-9)
    np.testing.assert_allclose(Xt.numpy(), N(Xj), rtol=0, atol=1e-8)
    np.testing.assert_allclose(epipolar.essential_from_pose(T(R2), T(t2)).numpy(),
                               N(jep.essential_from_pose(jnp.asarray(R2), jnp.asarray(t2))),
                               rtol=0, atol=1e-12)


def random_quartics(rng, n):
    """test_frontend.TestP3P._random_quartics: 4 / 2 / 0 real roots and a
    repeated root, random leading scale."""
    cs = []
    for i in range(n):
        kind = i % 4
        if kind == 0:
            c = np.poly(rng.normal(size=4) * 3)
        elif kind == 1:
            z = rng.normal() + 1j * abs(rng.normal())
            c = np.real(np.poly([rng.normal() * 3, rng.normal() * 3, z, np.conj(z)]))
        elif kind == 2:
            z1 = rng.normal() + 1j * abs(rng.normal())
            z2 = rng.normal() + 1j * abs(rng.normal())
            c = np.real(np.poly([z1, np.conj(z1), z2, np.conj(z2)]))
        else:
            r0 = rng.normal() * 3
            c = np.poly([r0, r0, rng.normal() * 3, rng.normal() * 3])
        cs.append(c * (rng.normal() + 0.1))
    return np.stack(cs)


def test_solve_quartic_and_p3p_match_jax(rng):
    C = random_quartics(rng, 200)
    rj, vj = jax.jit(jax.vmap(jp3p.solve_quartic))(jnp.asarray(C))
    rt, vt = p3p.solve_quartic(T(C))
    np.testing.assert_array_equal(vt.numpy(), N(vj))
    ok = N(vj)
    simple = np.arange(len(C)) % 4 != 3
    np.testing.assert_allclose(rt.numpy()[simple][ok[simple]], N(rj)[simple][ok[simple]],
                               rtol=0, atol=1e-9)
    # A repeated root is determined to ~sqrt(eps) only, and which slot gets
    # which of its two copies turns on the sign of a rounding-level m: the
    # JAX function's own jit and eager runs differ there by 7.5e-8.  These
    # quartics compare as sorted root sets, to 1e-6 relative (the bound of
    # test_frontend.py's own root check).
    for i in np.flatnonzero(~simple):
        a, b = np.sort(rt.numpy()[i][ok[i]]), np.sort(N(rj)[i][ok[i]])
        np.testing.assert_array_less(np.abs(a - b), 1e-6 * (1 + np.abs(b)))

    R = N(jso3.exp(jnp.asarray(rng.normal(size=3) * 0.4)))
    t = np.array([0.3, -0.2, 8.0])
    X = rng.uniform(-2, 2, size=(8, 3, 3)) + np.array([0, 0, 6.0])
    p = X @ R.T + t
    pn = p[..., :2] / p[..., 2:]
    Rs_j, ts_j = jax.jit(jax.vmap(jp3p.p3p))(jnp.asarray(X), jnp.asarray(pn))
    Rs_t, ts_t = p3p.p3p(T(X), T(pn))
    fin = np.isfinite(N(Rs_j)).all(axis=(-1, -2))
    np.testing.assert_array_equal(torch.isfinite(Rs_t).all(-1).all(-1).numpy(), fin)
    assert fin.any(axis=1).all()
    np.testing.assert_allclose(Rs_t.numpy()[fin], N(Rs_j)[fin], rtol=0, atol=1e-8)
    np.testing.assert_allclose(ts_t.numpy()[fin], N(ts_j)[fin], rtol=0, atol=1e-8)


def test_ransac_eight_point_matches_jax(rng):
    """test_frontend.TestRansac's case at 32 hypotheses: both sides fit the
    minimal sets JAX draws from the same key (the port gathers each set,
    JAX weights it one-hot)."""
    H = 32
    X, R2, t2, pn1, pn2 = two_view(rng, n=80, noise=1e-4)
    out_idx = rng.choice(80, size=20, replace=False)
    pn2[out_idx] += rng.uniform(0.05, 0.3, size=(20, 2))
    a1, a2 = jnp.asarray(pn1), jnp.asarray(pn2)
    key = jax.random.PRNGKey(0)
    ref = jax.jit(lambda k: jransac.ransac(
        k, 80, lambda idx, w: jep.eight_point(a1, a2, w=w, essential=True),
        lambda E: jep.sampson_distance(E, a1, a2),
        sample_size=8, n_hypotheses=H, threshold=1e-6))(key)
    idx = T(jax_draws(key, jnp.ones(80), H, 8))
    x1, x2 = T(pn1), T(pn2)

    def fit(idx_h, w):
        if idx_h is None:
            return epipolar.eight_point(x1, x2, w=w, essential=True)
        return epipolar.eight_point(x1[idx_h], x2[idx_h], essential=True)

    res = ransac.ransac(idx, 80, fit, lambda E: epipolar.sampson_distance(E, x1, x2),
                        sample_size=8, n_hypotheses=H, threshold=1e-6)
    assert int(res.best_hypothesis) == int(ref.best_hypothesis)
    np.testing.assert_array_equal(res.inliers.numpy(), N(ref.inliers))
    assert int(res.n_inliers) == int(ref.n_inliers) >= 55
    np.testing.assert_allclose(unit_up_to_sign(res.model), unit_up_to_sign(ref.model),
                               rtol=0, atol=1e-9)
    w_in = ref.inliers.astype(a1.dtype)
    Rj, tj, _, _ = jax.jit(jep.select_pose)(ref.model, a1, a2, w_in)
    Rt, tt, _, _ = epipolar.select_pose(res.model, x1, x2, w=T(N(w_in)))
    np.testing.assert_allclose(Rt.numpy(), N(Rj), rtol=0, atol=1e-8)
    np.testing.assert_allclose(tt.numpy() * np.sign(tt.numpy() @ N(tj)), N(tj), rtol=0, atol=1e-8)


def resection_case(rng, n, outlier_frac):
    X = rng.uniform(-2, 2, size=(n, 3)) + np.array([0, 0, 6.0])
    R = N(jso3.exp(jnp.asarray(rng.normal(size=3) * 0.3)))
    t = np.array([0.1, 0.4, 7.0])
    p = X @ R.T + t
    pn = p[:, :2] / p[:, 2:]
    pn += rng.normal(scale=5e-4, size=pn.shape)
    out = rng.random(n) < outlier_frac
    pn[out] += rng.uniform(0.05, 0.2, size=(int(out.sum()), 2))
    return X, pn, R, t, out


def test_pnp_matches_jax(rng):
    X, pn, R, t, out = resection_case(rng, 60, 0.25)
    w = (~out).astype(np.float64)
    for fn_j, fn_t in ((jpnp.pnp_dlt, pnp.pnp_dlt), (jpnp.pnp, pnp.pnp)):
        Rj, tj = jax.jit(fn_j)(jnp.asarray(X), jnp.asarray(pn), jnp.asarray(w))
        Rt, tt = fn_t(T(X), T(pn), T(w))
        np.testing.assert_allclose(Rt.numpy(), N(Rj), rtol=0, atol=1e-8)
        np.testing.assert_allclose(tt.numpy(), N(tj), rtol=0, atol=1e-8)
    # eigh's sign is arbitrary: the DLT fixes it by the depth sign, so a
    # flipped eigenvector gives the same pose.
    real_eigh = torch.linalg.eigh

    def flipped_eigh(M):
        e, V = real_eigh(M)
        return e, -V

    torch.linalg.eigh = flipped_eigh
    try:
        Rf, tf = pnp.pnp_dlt(T(X), T(pn), T(w))
    finally:
        torch.linalg.eigh = real_eigh
    Rd, td = pnp.pnp_dlt(T(X), T(pn), T(w))
    np.testing.assert_allclose(Rf.numpy(), Rd.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tf.numpy(), td.numpy(), rtol=0, atol=1e-12)

    key = jax.random.PRNGKey(1)
    Rj, tj, inl_j = jax.jit(partial(jpnp.pnp_ransac, n_hypotheses=16, threshold=1e-5))(
        key, jnp.asarray(X), jnp.asarray(pn))
    idx = T(jax_draws(key, jnp.ones(60), 16, 6))
    Rt, tt, inl_t = pnp.pnp_ransac(idx, T(X), T(pn), n_hypotheses=16, threshold=1e-5)
    np.testing.assert_array_equal(inl_t.numpy(), N(inl_j))
    assert not inl_t.numpy()[out].any()
    np.testing.assert_allclose(Rt.numpy(), N(Rj), rtol=0, atol=1e-8)
    np.testing.assert_allclose(tt.numpy(), N(tj), rtol=0, atol=1e-8)


def test_p3p_ransac_matches_jax(rng):
    """test_frontend.TestP3P's outlier case at 32 hypotheses, and the same
    two problems batched in one call (the pipeline's frame axis)."""
    X, pn, R, t, out = resection_case(rng, 100, 0.5)
    key = jax.random.PRNGKey(1)
    Rj, tj, inl_j = jax.jit(partial(jp3p.p3p_ransac, n_hypotheses=32, threshold=1e-5))(
        key, jnp.asarray(X), jnp.asarray(pn))
    idx = T(jax_draws(key, jnp.ones(100), 32, 3))
    Rt, tt, inl_t = p3p.p3p_ransac(idx, T(X), T(pn), n_hypotheses=32, threshold=1e-5)
    np.testing.assert_array_equal(inl_t.numpy(), N(inl_j))
    assert not inl_t.numpy()[out].any() and inl_t.numpy().sum() >= (~out).sum() - 2
    np.testing.assert_allclose(Rt.numpy(), N(Rj), rtol=0, atol=1e-8)
    np.testing.assert_allclose(tt.numpy(), N(tj), rtol=0, atol=1e-8)
    Rb, tb, inl_b = p3p.p3p_ransac(torch.stack([idx, idx]), T(X).expand(2, -1, -1),
                                   T(pn).expand(2, -1, -1), n_hypotheses=32, threshold=1e-5)
    for k in range(2):
        np.testing.assert_array_equal(inl_b[k].numpy(), inl_t.numpy())
        np.testing.assert_allclose(Rb[k].numpy(), Rt.numpy(), rtol=0, atol=1e-12)


def test_sample_indices():
    """Distinct indices per hypothesis, zero-weight entries never drawn,
    and the same draws for the same seed."""
    w = torch.ones(3, 50, dtype=torch.float64)
    w[1, 10:] = 0.0
    s1 = ransac.generator_sampler(5, "cpu")
    s2 = ransac.generator_sampler(5, "cpu")
    idx = s1(w, 64, 8)
    assert idx.shape == (3, 64, 8)
    assert all(len(set(r.tolist())) == 8 for r in idx.reshape(-1, 8))
    assert int(idx[1].max()) < 10
    assert torch.equal(idx, s2(w, 64, 8))
    assert not torch.equal(s1(w, 64, 8), idx)


def image_with_corners(rng, n=14):
    """test_frontend.TestFeatures._image_with_corners."""
    img = np.zeros((120, 160))
    pts = np.stack([rng.integers(20, 140, n), rng.integers(20, 100, n)], axis=-1)
    for x, y in pts:
        img[y:y + 9, x:x + 9] = rng.uniform(0.5, 1.0)
    return img + rng.normal(scale=0.01, size=img.shape)


def test_features_and_match_match_jax(rng):
    img = image_with_corners(rng)
    img2 = np.roll(img, 7, axis=1)
    np.testing.assert_allclose(features.harris_response(T(img)).numpy(),
                               N(jax.jit(jfeat.harris_response)(jnp.asarray(img))),
                               rtol=0, atol=1e-10)
    detect = jax.jit(partial(jfeat.detect_and_describe, n_keypoints=64))
    (kj1, dj1), (kj2, dj2) = (detect(jnp.asarray(a)) for a in (img, img2))
    kt, dt = features.detect_and_describe(T(np.stack([img, img2])), 64)
    for f, (kj, dj) in enumerate(((kj1, dj1), (kj2, dj2))):
        vj, vt = N(kj.valid), kt.valid[f].numpy()
        assert vj.sum() == vt.sum() > 10
        xy_j = N(kj.xy)[vj]
        xy_t = kt.xy[f].numpy()[vt]
        oj = np.lexsort(np.round(xy_j, 6).T[::-1])
        ot = np.lexsort(np.round(xy_t, 6).T[::-1])
        np.testing.assert_allclose(xy_t[ot], xy_j[oj], rtol=0, atol=1e-10)
        # Descriptors at the JAX keypoints.
        d_t = features.describe_patches(T(img if f == 0 else img2),
                                        features.Keypoints(T(kj.xy), T(kj.score), T(kj.valid)))
        d_j = jax.jit(jfeat.describe_patches)(jnp.asarray(img if f == 0 else img2), kj)
        np.testing.assert_allclose(d_t.numpy(), N(d_j), rtol=0, atol=1e-10)
    # A batch of frames gives what each frame gives alone.
    k1, d1 = features.detect_and_describe(T(img), 64)
    np.testing.assert_array_equal(k1.valid.numpy(), kt.valid[0].numpy())
    np.testing.assert_allclose(k1.xy.numpy(), kt.xy[0].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(d1.numpy(), dt[0].numpy(), rtol=0, atol=1e-12)
    # Matching the JAX descriptors on both sides: the same valid matches.
    mj = jax.jit(jmatch.match_descriptors)(dj1, dj2, valid1=kj1.valid, valid2=kj2.valid)
    mt = match.match_descriptors(T(dj1), T(dj2), valid1=T(kj1.valid), valid2=T(kj2.valid))
    ok = N(mj.valid)
    assert ok.sum() >= 10
    np.testing.assert_array_equal(mt.valid.numpy(), ok)
    np.testing.assert_array_equal(mt.idx2.numpy()[ok], N(mj.idx2)[ok])
    np.testing.assert_allclose(mt.score.numpy()[ok], N(mj.score)[ok], rtol=0, atol=1e-12)
