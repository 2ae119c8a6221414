"""L4 pipeline: synthetic scenes, the incremental SfM pipeline and tracking
from images (``run_from_images``: images -> tracks -> incremental SfM)."""

from pysfm_tpu_torch.pipeline import synthetic  # noqa: F401
from pysfm_tpu_torch.pipeline.incremental import (  # noqa: F401
    IncrementalConfig,
    Reconstruction,
    run_incremental,
)
from pysfm_tpu_torch.pipeline.tracks import (  # noqa: F401
    TrackingConfig,
    build_tracks,
    run_from_images,
)
