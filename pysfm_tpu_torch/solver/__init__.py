"""L2 optimizer: LM + Schur complement, dense component-major and matrix-free
pcg routes."""

from pysfm_tpu_torch.solver import schur, schur_cm  # noqa: F401
from pysfm_tpu_torch.solver.lm import LMStats, solve  # noqa: F401
from pysfm_tpu_torch.utils.config import LMConfig  # noqa: F401
