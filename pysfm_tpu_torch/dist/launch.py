"""Start a world of ranks on one machine.

- ``spawn(fn, nproc, ...)`` runs ``fn(mesh, *args)`` in ``nproc`` new
  processes joined over ``tcp://localhost:<free port>`` and returns their
  results in rank order;
- ``run_script(script, nproc, ...)`` runs a script in ``nproc``
  interpreters that join through torchrun's variables (``MASTER_ADDR``,
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) and returns
  their output.

These are the one-machine counterparts of torchrun for the example, the
chip smoke script and the tests.  Each rank is a fresh interpreter (the
``spawn`` start method, or a new process); ``fn`` travels by its import
path and must be importable from a module that does not import JAX.  Every rank joins with a
collective timeout, the parent waits at most ``timeout`` seconds for the
whole world, and a rank that fails or a world that outlives the wait makes
:func:`spawn` raise after every rank has been stopped.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import subprocess
import sys
import tempfile
import time
import traceback

import torch.distributed as tdist

from pysfm_tpu_torch.dist import multihost


def _rank_main(rank, nproc, port, backend, device, timeout, fn, args, results):
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        multihost.initialize(f"localhost:{port}", nproc, rank, backend=backend,
                             device=device, timeout=timeout)
        mesh = multihost.global_mesh(device=device)
        out = fn(mesh, *args)
        multihost.shutdown()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        if tdist.is_initialized():
            tdist.destroy_process_group()
        raise


def spawn(fn, nproc: int, args=(), *, backend=None, device=None,
          timeout: float = 120.0) -> list:
    """Run ``fn(mesh, *args)`` on ``nproc`` ranks; returns the ``nproc``
    results (picklable) in rank order.

    ``device`` is every rank's device (``"cpu"``, ``"cuda:0"``; default
    ``cuda:<rank>``), ``backend`` the process group's (default NCCL, gloo
    for ``device="cpu"``).  Raises ``RuntimeError`` with the failing rank's
    traceback, or ``TimeoutError`` when the world does not finish within
    ``timeout`` seconds; either way no rank is left running."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = multihost.free_port()
    dev = (lambda r: f"cuda:{r}") if device is None else (lambda r: device)
    procs = [
        ctx.Process(target=_rank_main, daemon=True,
                    args=(r, nproc, port, backend, dev(r), timeout, fn, args, results))
        for r in range(nproc)
    ]
    for pr in procs:
        pr.start()
    out, deadline = {}, time.monotonic() + timeout
    try:
        # Drain the queue before joining: a rank blocks in put() until read.
        while len(out) < nproc:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"spawn: {nproc} ranks did not finish in {timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, pr in enumerate(procs)
                        if r not in out and pr.exitcode not in (None, 0)]
                if not dead:
                    continue
                try:  # a failed rank's report may land just after its exit
                    rank, ok, value = results.get(timeout=2.0)
                except queue.Empty:
                    raise RuntimeError(
                        f"spawn: rank(s) {dead} exited with "
                        f"{[procs[r].exitcode for r in dead]} and no report") from None
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} failed:\n{value}")
            out[rank] = value
        for pr in procs:
            pr.join(max(deadline - time.monotonic(), 1.0))
            if pr.is_alive() or pr.exitcode != 0:
                raise RuntimeError(f"spawn: a rank exited with {pr.exitcode}")
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join(5.0)
    return [out[r] for r in range(nproc)]


def run_script(script: str, nproc: int, args=(), *, timeout: float = 120.0,
               env=None) -> list:
    """Run ``python script *args`` as ranks 0..nproc-1 of one world (the
    rank in ``RANK``, the rendezvous in ``MASTER_ADDR`` / ``MASTER_PORT``);
    returns each rank's combined output.  Raises ``RuntimeError`` with the
    outputs when a rank exits non-zero, ``TimeoutError`` when the world
    outlives ``timeout`` seconds; no rank is left running either way."""
    base = dict(os.environ if env is None else env, MASTER_ADDR="localhost",
                MASTER_PORT=str(multihost.free_port()), WORLD_SIZE=str(nproc))
    # Outputs go to files, not pipes: a rank blocked on a full pipe would
    # block the others in a collective.
    files = [tempfile.TemporaryFile() for _ in range(nproc)]
    procs = [
        subprocess.Popen([sys.executable, script, *map(str, args)],
                         env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                         stdout=files[r], stderr=subprocess.STDOUT)
        for r in range(nproc)
    ]
    deadline = time.monotonic() + timeout
    try:
        for pr in procs:
            try:
                pr.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                raise TimeoutError(f"run_script: {script} did not finish in {timeout} s") from None
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait(5.0)
        logs = []
        for f in files:
            f.seek(0)
            logs.append(f.read().decode(errors="replace"))
            f.close()
    bad = [r for r, pr in enumerate(procs) if pr.returncode != 0]
    if bad:
        raise RuntimeError(f"run_script: rank(s) {bad} failed:\n" +
                           "\n".join(f"--- rank {r} ---\n{logs[r]}" for r in bad))
    return logs
