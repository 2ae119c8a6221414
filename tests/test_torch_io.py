"""The port's I/O layer (``pysfm_tpu_torch/io``) against the JAX package's:
files move between the two packages in both directions.

- BAL (``.bal``, ``.gz``, ``.bz2``) and Bundler files written by one
  package load in the other with the arrays the other package's own loader
  gives.  Parsed values are exact; R goes through Rodrigues in f64 in each
  package (log on save, exp on load), whose last bits differ: 1e-12.
- ``save_checkpoint`` / ``save_checkpoint_cm`` files written by either
  package load in the other with every field exact (the same npz fields,
  dtypes and JSON sidecar).
- The C++ tokenizer and writer and their NumPy fallbacks give the same
  numbers and the same bytes.
- A CM load -> pcg solve -> checkpoint -> resume on the CPU in f64: the
  resumed cost log equals the tail of the straight solve to 1e-5, the gate
  of ``test_io.py`` (the checkpoint does not carry the CG warm start).
"""

import dataclasses
import inspect
import json

import numpy as np
import pytest
import torch

from pysfm_tpu import io as jio
from pysfm_tpu.pipeline import synthetic as jsyn
from pysfm_tpu.problem import cm as jcm
from pysfm_tpu_torch import io as tio
from pysfm_tpu_torch.io import native
from pysfm_tpu_torch.problem import cm as tcm
from pysfm_tpu_torch.problem import problem as tprob
from pysfm_tpu_torch.solver import LMConfig, solve
from pysfm_tpu_torch.solver.lm import solve_segmented

torch.set_num_threads(2)
EXACT_FIELDS = ("t", "intr", "X", "obs_cam", "obs_pt", "obs_uv", "obs_w", "pt_obs",
                "pt_obs_mask", "cam_obs", "cam_obs_mask", "cam_fixed", "robust_scale")


@pytest.fixture(scope="module")
def jscene():
    return jsyn.make_scene(5, 80, camera_model="bal", noise_px=0.3, visibility=0.8, seed=3)


def _to_port(p):
    arrays = {k: np.asarray(getattr(p, k)) for k in tprob.FIELDS}
    return tprob.from_numpy(arrays, p.camera_model, p.robust, device="cpu")


def _same_problem(pj, pt, fields=tprob.FIELDS):
    """A JAX and a port problem hold the same arrays (R to 1e-12)."""
    assert (pj.camera_model, pj.robust) == (pt.camera_model, pt.robust)
    for k in fields:
        x, y = np.asarray(getattr(pj, k)), getattr(pt, k).numpy()
        assert x.dtype == y.dtype and x.shape == y.shape, k
        if k in EXACT_FIELDS or k not in tprob.FIELDS:
            np.testing.assert_array_equal(y, x, err_msg=k)
        else:
            np.testing.assert_allclose(y, x, rtol=1e-12, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("suffix", [".bal", ".bal.gz", ".bal.bz2"])
def test_bal_files_move_both_ways(tmp_path, jscene, suffix):
    p = jscene.problem
    a, b = str(tmp_path / f"jax{suffix}"), str(tmp_path / f"port{suffix}")
    jio.save_bal(a, p)
    tio.save_bal(b, _to_port(p))
    for path in (a, b):
        _same_problem(jio.load_bal(path), tio.load_bal(path, device="cpu"))
    # The port's file re-read by JAX is the problem it was written from.
    q = jio.load_bal(b)
    np.testing.assert_allclose(np.asarray(q.R), np.asarray(p.R), atol=1e-12)
    np.testing.assert_array_equal(np.asarray(q.X), np.asarray(p.X))
    if suffix == ".bal":
        kw = dict(layout="cm", dtype=np.float32, robust="huber", robust_scale=2.0)
        cj, ct = jio.load_bal(a, **kw), tio.load_bal(a, device="cpu", **kw)
        assert isinstance(ct, tcm.CMProblem)
        for k in tcm.FIELDS:
            x, y = np.asarray(getattr(cj, k)), getattr(ct, k).numpy()
            assert x.dtype == y.dtype, k
            np.testing.assert_allclose(y, x, rtol=1e-6, atol=1e-7, err_msg=k)


def test_bundler_files_move_both_ways(tmp_path, jscene):
    p = jscene.problem
    rng = np.random.default_rng(1)
    colors = rng.integers(0, 256, (p.n_points, 3)).astype(np.uint8)
    keys = rng.integers(0, 1000, p.n_obs).astype(np.int32)
    a, b = str(tmp_path / "jax.out"), str(tmp_path / "port.out")
    jio.save_bundler(a, p, colors=colors, keys=keys)
    tio.save_bundler(b, _to_port(p), colors=colors, keys=keys)
    assert open(a).read() == open(b).read()
    for path in (a, b):
        (pj, ej), (pt, et) = jio.load_bundler(path), tio.load_bundler(path, device="cpu")
        _same_problem(pj, pt)
        np.testing.assert_array_equal(et.colors, colors)
        np.testing.assert_array_equal(et.keys, ej.keys)


def test_pose_model_rejected(tmp_path):
    from pysfm_tpu_torch.pipeline import synthetic as tsyn

    p = tsyn.make_scene(2, 10, camera_model="pose", seed=0, device="cpu").problem
    with pytest.raises(ValueError, match="camera_model='bal'"):
        tio.save_bal(str(tmp_path / "x.bal"), p)
    with pytest.raises(ValueError, match="camera_model='bal'"):
        tio.save_bundler(str(tmp_path / "x.out"), p)


def _npz_equal(a, b):
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        assert za[k].dtype == zb[k].dtype, k
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    assert json.load(open(a + ".json")) == json.load(open(b + ".json"))


def test_checkpoints_move_both_ways(tmp_path):
    """save_checkpoint and save_checkpoint_cm of either package: the same
    npz and sidecar, and each loads in the other package with every field
    exact."""
    p = jsyn.make_scene(4, 30, camera_model="pose_k", robust="cauchy", robust_scale=1.5,
                        noise_px=0.3, seed=2, dtype=np.float32).problem
    tp = _to_port(p)
    a, b = str(tmp_path / "ckpt_3.npz"), str(tmp_path / "ckpt_7.npz")
    jio.save_checkpoint(a, jio.SolverCheckpoint(p, lam=0.25, nu=4.0, iteration=3,
                                                extra={"k": 1}))
    tio.save_checkpoint(b, tio.SolverCheckpoint(tp, lam=0.25, nu=4.0, iteration=3,
                                                extra={"k": 1}))
    _npz_equal(a, b)
    for path in (a, b):
        cj, ct = jio.load_checkpoint(path), tio.load_checkpoint(path, device="cpu")
        _same_problem(cj.problem, ct.problem)
        assert (ct.lam, ct.nu, ct.iteration, ct.extra) == (0.25, 4.0, 3, {"k": 1})
        assert (cj.lam, cj.nu, cj.iteration) == (ct.lam, ct.nu, ct.iteration)

    cmj = jcm.from_problem(p)
    cmt = tcm.from_problem(tp)
    a, b = str(tmp_path / "cm_j.npz"), str(tmp_path / "cm_t.npz")
    jio.save_checkpoint_cm(a, cmj, lam=0.5, nu=8.0, iteration=6)
    tio.save_checkpoint_cm(b, cmt, lam=0.5, nu=8.0, iteration=6)
    _npz_equal(a, b)
    for path in (a, b):
        rj, rt = jio.load_checkpoint_cm(path), tio.load_checkpoint_cm(path, device="cpu")
        assert rt[1:] == rj[1:] == (0.5, 8.0, 6)
        for k in tcm.FIELDS:
            x, y = np.asarray(getattr(rj[0], k)), getattr(rt[0], k).numpy()
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(y, x, err_msg=k)
    with pytest.raises(ValueError, match="not a CM checkpoint"):
        tio.load_checkpoint_cm(str(tmp_path / "ckpt_3.npz"), device="cpu")

    # latest_checkpoint: highest iteration with a sidecar; a torn write
    # (npz without sidecar) is skipped.
    assert tio.latest_checkpoint(str(tmp_path)) == str(tmp_path / "ckpt_7.npz")
    np.savez(str(tmp_path / "ckpt_9.npz"), x=np.zeros(1))
    assert tio.latest_checkpoint(str(tmp_path)) == str(tmp_path / "ckpt_7.npz")
    assert tio.latest_checkpoint(str(tmp_path), prefix="none") is None
    assert jio.latest_checkpoint(str(tmp_path)) == tio.latest_checkpoint(str(tmp_path))
    # The sharded loaders read part files only (<path>.p<rank>).
    with pytest.raises(FileNotFoundError, match="no checkpoint parts"):
        tio.load_checkpoint_sharded_cm(a)


def test_native_and_numpy_fallback_agree(tmp_path, jscene, monkeypatch):
    assert native.have_native()
    tp = _to_port(jscene.problem)
    path_n, path_f = str(tmp_path / "n.bal"), str(tmp_path / "f.bal")
    tio.save_bal(path_n, tp)
    data = open(path_n, "rb").read()
    parsed = native.parse_doubles(data)
    assert native.library_path().exists()
    monkeypatch.setattr(native, "_load", lambda: None)
    np.testing.assert_array_equal(native.parse_doubles(data), parsed)
    np.testing.assert_array_equal(native.parse_doubles(data, 7), parsed[:7])
    tio.save_bal(path_f, tp)
    assert open(path_f, "rb").read() == data


def test_loaders_default_to_the_card():
    for fn in (tio.load_bal, tio.load_bundler, tio.load_checkpoint, tio.load_checkpoint_cm):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def test_cm_load_solve_checkpoint_resume(tmp_path, jscene):
    """BAL file -> CMProblem -> pcg solve -> checkpoint at the half ->
    resume with the saved damping state: the tail matches the straight
    solve (f64, pcg without kernel operands)."""
    path = str(tmp_path / "scene.bal")
    tio.save_bal(path, _to_port(jscene.problem))
    cmp = tio.load_bal(path, layout="cm", robust="huber", robust_scale=2.0, device="cpu")
    cfg = LMConfig(max_iters=8, tol_grad=0.0, tol_cost_rel=0.0, tol_step=0.0,
                   solver="pcg", cg_iters=15, cg_tol=1e-6)
    _, st_full = solve_segmented(cmp, cfg, iters_per_dispatch=4)
    half = dataclasses.replace(cfg, max_iters=4)
    p_half, st_half = solve(cmp, half)
    ck = str(tmp_path / "cm_ckpt.npz")
    tio.save_checkpoint_cm(ck, p_half, lam=float(st_half.lam_next),
                           nu=float(st_half.nu_next), iteration=4)
    cmp_r, lam_r, nu_r, it_r = tio.load_checkpoint_cm(ck, device="cpu")
    assert it_r == 4 and torch.equal(cmp_r.X3, p_half.X3)
    _, st_res = solve(cmp_r, half, lam_init=lam_r, nu_init=nu_r)
    c_full, c_res = st_full.costs.numpy(), st_res.costs.numpy()
    assert c_full[-1] < c_full[0]
    np.testing.assert_allclose(c_res[1:], c_full[5:], rtol=1e-5)
