"""Device tracing helpers over ``torch.profiler``.

Port of :mod:`pysfm_tpu.utils.trace`: a context manager that captures a
trace of everything run inside it (host ops and, on a card, the CUDA
kernels), written as a Chrome / Perfetto JSON trace, and helpers that name
regions in it.  The per-kernel accounting lives in ``chip_smoke.py``; this
module is for looking at a schedule when the numbers surprise you.

Usage::

    from pysfm_tpu_torch.utils import trace

    with trace.capture("/tmp/ba_trace"):
        solve(problem, cfg)         # then open the .json in ui.perfetto.dev

    with trace.annotate("build_normal_equations"):
        eqs = build(...)            # named region inside a capture
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def capture(log_dir: str) -> Iterator[None]:
    """Trace the enclosed work into ``log_dir/trace_<pid>_<ns>.json``
    (Chrome trace format; ui.perfetto.dev or chrome://tracing).  CUDA
    activity is recorded when a card is present."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    )


def annotate(name: str):
    """Named region for the trace timeline (nests)."""
    return record_function(name)


def annotate_fn(fn, name: str | None = None):
    """Wrap ``fn`` so every call shows up as a named trace region."""
    label = name or getattr(fn, "__name__", "fn")

    def wrapped(*a, **kw):
        with record_function(label):
            return fn(*a, **kw)

    return wrapped
