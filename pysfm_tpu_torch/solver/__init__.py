"""L2 optimizer: LM + Schur complement on the dense component-major route."""

from pysfm_tpu_torch.solver import schur, schur_cm  # noqa: F401
from pysfm_tpu_torch.solver.lm import LMStats, solve  # noqa: F401
from pysfm_tpu_torch.utils.config import LMConfig  # noqa: F401
