"""I/O layer: problem files and checkpoints.

- :mod:`pysfm_tpu_torch.io.bal` — BAL problem files (``.gz`` / ``.bz2`` too)
- :mod:`pysfm_tpu_torch.io.bundler` — Bundler ``.out`` v0.3
- :mod:`pysfm_tpu_torch.io.checkpoint` — mid-solve checkpoint / resume, in
  the JAX package's file format
- :mod:`pysfm_tpu_torch.io.native` — the C++ tokenizer and BAL writer
- :mod:`pysfm_tpu_torch.io.viz` — camera frusta / point cloud / overlay
  plots (matplotlib, imported when a plot is drawn)
"""

from pysfm_tpu_torch.io.bal import load_bal, save_bal
from pysfm_tpu_torch.io.bundler import load_bundler, save_bundler
from pysfm_tpu_torch.io.checkpoint import (
    SolverCheckpoint,
    latest_checkpoint,
    load_checkpoint,
    load_checkpoint_cm,
    load_checkpoint_sharded,
    load_checkpoint_sharded_cm,
    save_checkpoint,
    save_checkpoint_cm,
    save_checkpoint_sharded,
    save_checkpoint_sharded_cm,
)

__all__ = [
    "load_bal", "save_bal", "load_bundler", "save_bundler",
    "SolverCheckpoint", "save_checkpoint", "load_checkpoint",
    "save_checkpoint_sharded", "load_checkpoint_sharded",
    "save_checkpoint_cm", "load_checkpoint_cm",
    "save_checkpoint_sharded_cm", "load_checkpoint_sharded_cm",
    "latest_checkpoint",
]
