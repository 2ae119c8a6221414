"""Device-completion fences for benchmarking.

PyTorch returns from a CUDA call before the device finishes, so a host
clock read without a fence measures the enqueue.  :func:`sync` waits for
every stream of the current device; on the CPU it is a no-op.
"""

from __future__ import annotations

import time

import torch


def sync() -> None:
    """Wait until all work queued on the current CUDA device has finished."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit(fn, *args, n: int = 20, **kw) -> float:
    """Mean seconds/call over ``n`` calls after one warmup call."""
    fn(*args, **kw)
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args, **kw)
    sync()
    return (time.perf_counter() - t0) / n
