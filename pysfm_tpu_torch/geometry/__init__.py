"""L0 math primitives: SO(3) and projection models."""

from pysfm_tpu_torch.geometry import projection, so3  # noqa: F401
