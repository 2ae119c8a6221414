"""Hand-written CUDA kernels for Hopper (``pysfm_tpu_torch/csrc``), each with
its plain PyTorch version beside it.

The package exports the projection kernel's two standard-layout entries,
the counterparts of the JAX package's ``residuals_and_jacobians_pallas``
and ``residuals_jacobians_weights``."""

from pysfm_tpu_torch.solver.kernels.proj import (  # noqa: F401
    residuals_and_jacobians,
    residuals_jacobians_weights,
)
