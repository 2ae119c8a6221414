"""L4 pipeline: synthetic scenes (the incremental pipeline is not ported yet)."""

from pysfm_tpu_torch.pipeline import synthetic  # noqa: F401
