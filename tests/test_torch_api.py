"""The port does all that the JAX package does.

Every module of ``pysfm_tpu`` has its namesake in ``pysfm_tpu_torch``; each
public function, class and constant defined there (read from the module's
source, so jitted functions count) is defined in the port's module too, not
re-imported, with each of its parameters and each public method of a
class; each name a package's ``__init__`` re-exports is re-exported by the
port's; and each script in ``examples/`` has its counterpart in
``pysfm_tpu_torch/examples/`` with a ``run`` and a ``main`` that default to
the card.  The tables below are the only exceptions, each with its reason.
"""

import ast
import importlib
import inspect
import pathlib
import pkgutil

import numpy as np
import pytest
import torch

import pysfm_tpu

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX, PORT = "pysfm_tpu", "pysfm_tpu_torch"

# JAX module -> (the port module that replaces it, {JAX name: port name}, reason).
REPLACED_MODULES = {
    "problem.grouped": (
        "solver.kernels.spmv",
        {"CGRP": None, "PCH": None, "BLK": None, "GroupedMeta": "GroupedOps",
         "build_grouped": "grouped_ops"},
        "the grouped observation stream and its constants come from the TPU's (8, 128) "
        "register shape; the port holds a CSR layout with a camera permutation and the "
        "kernels' plans in spmv.GroupedOps"),
    "solver.kernels.pallas_proj": (
        "solver.kernels.proj",
        {"TILE_M": None,
         "residuals_jacobians_weights_cm": "residuals_jacobians_weights_cm",
         "residuals_jacobians_weights": "residuals_jacobians_weights",
         "residuals_and_jacobians_pallas": "residuals_and_jacobians",
         "residuals_and_jacobians_pallas_cm": "residuals_and_jacobians_cm"},
        "the Pallas projection kernel is csrc/proj.cu behind proj.py's wrappers; TILE_M "
        "padding and interpret mode are TPU machinery"),
    "solver.kernels.pallas_spmv": (
        "solver.kernels.spmv",
        {"NSL": None, "SUB": None, "GroupedOps": "GroupedOps", "device_grouped": "grouped_ops",
         "permute_b_rows": "build_eqs",
         "hcpT_x_grouped": "hcpT_x", "hcpT_x_grouped2": "hcpT_x",
         "hcp_w_grouped": "hcp_w", "hcp_w_grouped2": "hcp_w",
         "payload_b_grouped": "payload_b", "build_eqs_grouped": "build_eqs",
         "precond_diag_grouped": "precond_diag", "cost_grouped": "cost"},
        "the Pallas pcg kernels are csrc/eqs.cu and csrc/spmv.cu behind spmv.py's wrappers; "
        "K_A2/K_B2 (the TPU's two-phase schedule) map to K_A/K_B, and K_E emits the "
        "camera-sorted rows (b_cam) that permute_b_rows made"),
}
# JAX modules and names with no port.
DROPPED = {
    "utils.compcache": "an XLA compilation cache; the port compiles only its CUDA sources, "
                       "once, into build/",
    "utils.enable_compilation_cache": "the XLA compilation cache (utils.compcache)",
    "utils.precision.HIGHEST": "a JAX matmul-precision constant; the port turns TF32 off at "
                               "import instead (utils/precision.py)",
}
# A parameter renamed or dropped in every function that has it:
# JAX name -> (port name or None, reason).
RENAMED_PARAMS = {
    "axis_name": ("group", "a shard_map axis name; the port's collectives take a dist.Mesh "
                           "over torch.distributed"),
    "key": ("rng", "a jax.random key; torch cannot repeat its stream, so the port draws from "
                   "a torch.Generator (or takes a sampler)"),
    "superstep": (None, "the TPU's two-phase (superstep) schedule of K_A2/K_B2"),
}
# A parameter of one function: (JAX function, JAX name) -> (port name or None, reason).
PARAM_DEPARTURES = {
    ("dist.mesh.make_mesh", "devices"): (
        "device", "a list of JAX devices; a rank holds one torch device"),
    ("dist.sharded_cm.shard_cm_problem", "with_grouped"): (
        None, "shard_map's stacked per-shard GroupedOps, padded to one static shape; each "
              "rank builds its own in device_put_sharded_cm(with_grouped=...)"),
    ("dist.sharded_cm.device_put_sharded_cm", "sgops"): (
        None, "the stacked per-shard GroupedOps (see shard_cm_problem)"),
    ("utils.precision.einsum", "kw"): (
        None, "jnp.einsum's precision= keyword; torch.einsum takes none, and TF32 is off"),
    ("utils.timing.sync", "tree"): (
        None, "JAX blocks on one leaf of a tree; a CUDA synchronize waits for all queued work"),
}


def _modules():
    """Every module of the JAX package, relative to it ("" for the root)."""
    names = [""]
    for m in pkgutil.walk_packages(pysfm_tpu.__path__, JAX + "."):
        names.append(m.name[len(JAX) + 1:])
    return names


MODULES = _modules()


def _full(pkg, rel):
    return pkg if not rel else f"{pkg}.{rel}"


def _source(rel):
    base = ROOT / JAX / rel.replace(".", "/")
    return base / "__init__.py" if base.is_dir() else base.with_suffix(".py")


def _defined(rel):
    """(functions and classes, constants): the public names the module's
    source defines at its top level."""
    tree = ast.parse(_source(rel).read_text())
    defs, consts = [], []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            defs.append(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            consts += [t.id for t in targets if isinstance(t, ast.Name)]
    public = [n for n in defs if not n.startswith("_")]
    return public, [n for n in consts if not n.startswith("_")]


def _reexports(rel):
    """The public names a package's ``__init__`` imports from the JAX
    package (none for a plain module: its imports are its own business)."""
    if _source(rel).name != "__init__.py":
        return []
    tree = ast.parse(_source(rel).read_text())
    out = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith(JAX):
            origin = node.module[len(JAX) + 1:]
            out += [(a.asname or a.name, origin) for a in node.names
                    if not (a.asname or a.name).startswith("_")]
    return out


def _port_name(name, origin):
    """The port's name for a name re-exported from JAX module ``origin``."""
    if origin in REPLACED_MODULES:
        return REPLACED_MODULES[origin][1][name]
    return name


def _params(obj):
    return list(inspect.signature(inspect.unwrap(obj)).parameters)


def _check_params(rel, name, jobj, pobj):
    """Each JAX parameter is in the port, or renamed or dropped by a table."""
    missing = []
    pparams = _params(pobj)
    for p in _params(jobj):
        rename = PARAM_DEPARTURES.get((f"{rel}.{name}", p)) or RENAMED_PARAMS.get(p)
        want = rename[0] if rename else p
        if want is not None and want not in pparams:
            missing.append(p if want == p else f"{p} (as {want})")
    return missing


@pytest.mark.parametrize("rel", [m for m in MODULES if m not in REPLACED_MODULES
                                 and m not in DROPPED], ids=lambda m: m or JAX)
def test_module_is_ported(rel):
    jmod, pmod = importlib.import_module(_full(JAX, rel)), importlib.import_module(_full(PORT, rel))
    defs, consts = _defined(rel)
    faults = []
    for name in defs + consts:
        if f"{rel}.{name}" in DROPPED:
            continue
        if not hasattr(pmod, name):
            faults.append(f"{name}: missing")
            continue
        jobj, pobj = getattr(jmod, name), getattr(pmod, name)
        if name in consts:
            continue
        if getattr(inspect.unwrap(pobj), "__module__", None) != pmod.__name__:
            faults.append(f"{name}: re-imported from {inspect.unwrap(pobj).__module__}")
            continue
        missing = _check_params(rel, name, jobj, pobj)
        if missing:
            faults.append(f"{name}: parameters {missing} missing")
        if inspect.isclass(jobj):
            methods = [m for m, v in vars(jobj).items() if not m.startswith("_")
                       and (callable(v) or isinstance(v, (staticmethod, classmethod)))]
            faults += [f"{name}.{m}: method missing" for m in methods if not hasattr(pobj, m)]
    for name, origin in _reexports(rel):
        if f"{rel}.{name}" in DROPPED:
            continue
        if not hasattr(pmod, _port_name(name, origin)):
            faults.append(f"{name}: not re-exported (as {_port_name(name, origin)})")
    assert not faults, f"{_full(PORT, rel)}: " + "; ".join(faults)


@pytest.mark.parametrize("rel", sorted(REPLACED_MODULES))
def test_replaced_module_has_counterparts(rel):
    """A module the port replaces on purpose: each of its public names maps
    to a name of the replacement (or to none, for TPU layout constants)."""
    target, names, reason = REPLACED_MODULES[rel]
    assert reason
    assert not (ROOT / PORT / (rel.replace(".", "/") + ".py")).exists()
    pmod = importlib.import_module(_full(PORT, target))
    defs, consts = _defined(rel)
    assert sorted(defs + consts) == sorted(names), "the table misses a name of the module"
    for name, port_name in names.items():
        if port_name is None:
            assert name in consts, f"only a constant may go unported: {name}"
        else:
            assert callable(getattr(pmod, port_name)), f"{rel}.{name} -> {target}.{port_name}"


def test_kernels_package_exports_the_projection_entries():
    """The JAX kernels package re-exports two projection entries; the port's
    exports their counterparts (REPLACED_MODULES maps the names)."""
    from pysfm_tpu_torch.solver import kernels
    from pysfm_tpu_torch.solver.kernels import proj

    exports = _reexports("solver.kernels")
    assert len(exports) == 2
    for name, origin in exports:
        assert getattr(kernels, _port_name(name, origin)) is getattr(proj, _port_name(name, origin))


def test_dropped_and_renamed_are_still_in_the_reference():
    """Every entry of the tables names something the JAX package still has,
    so a stale exception cannot hide a missing port."""
    for rel, reason in DROPPED.items():
        assert reason
        if rel in MODULES:
            assert not (ROOT / PORT / (rel.replace(".", "/") + ".py")).exists()
        else:
            mod, name = rel.rsplit(".", 1)
            assert hasattr(importlib.import_module(_full(JAX, mod)), name), rel
            assert not hasattr(importlib.import_module(_full(PORT, mod)), name), rel
    for (fn, p), (_, reason) in PARAM_DEPARTURES.items():
        mod, name = fn.rsplit(".", 1)
        assert reason and p in _params(getattr(importlib.import_module(_full(JAX, mod)), name)), fn
    used = {p for rel in MODULES if rel not in REPLACED_MODULES and rel not in DROPPED
            for name in _defined(rel)[0]
            for p in _params(getattr(importlib.import_module(_full(JAX, rel)), name))}
    assert set(RENAMED_PARAMS) <= used


EXAMPLES = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_is_ported(name):
    """Each JAX example has its counterpart, with a ``run`` and a ``main``
    defined there."""
    mod = importlib.import_module(f"{PORT}.examples.{name}")
    for fn in ("run", "main"):
        assert inspect.getmodule(getattr(mod, fn)) is mod, f"{name}.{fn}"


class _Called(Exception):
    pass


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_defaults_to_the_card(name, monkeypatch):
    """``run`` defaults to the card in f32 and raises without one (no CPU
    fallback); ``main`` with no arguments runs on the card."""
    mod = importlib.import_module(f"{PORT}.examples.{name}")
    params = inspect.signature(mod.run).parameters
    assert params["device"].default == "cuda"
    assert params["dtype"].default is np.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            mod.run()
    seen = {}

    def fake_run(*args, **kw):
        seen.update(inspect.signature(mod.run).bind(*args, **kw).arguments)
        raise _Called

    monkeypatch.setattr(mod, "run", fake_run)
    with pytest.raises(_Called):
        mod.main([])
    assert seen.get("device", "cuda") == "cuda"
