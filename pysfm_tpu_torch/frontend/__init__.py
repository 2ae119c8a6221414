"""L3 geometric front end: features, matching, epipolar geometry, RANSAC,
triangulation, PnP and P3P (port of :mod:`pysfm_tpu.frontend`)."""

from pysfm_tpu_torch.frontend import (  # noqa: F401
    epipolar,
    features,
    match,
    p3p,
    pnp,
    ransac,
    triangulate,
)
