"""L1 measurement model: SoA bundle problem + robust costs."""

from pysfm_tpu_torch.problem import robust  # noqa: F401
from pysfm_tpu_torch.problem.problem import (  # noqa: F401
    BundleProblem,
    apply_update,
    build_point_obs_table,
    cost,
    from_numpy,
    make_problem,
    residuals,
    residuals_and_jacobians,
)
