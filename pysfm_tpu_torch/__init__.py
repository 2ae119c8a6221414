"""pysfm_tpu_torch — the PyTorch/CUDA port of :mod:`pysfm_tpu`.

Same subpackage and module names as the JAX package, PyTorch idiom inside:
plain functions on tensors, dataclasses of tensors, an explicit ``device=``
wherever a tensor is made, and numpy ``Generator``s for scene randomness.
The JAX package stays the reference; ``tests/test_torch_*.py`` hold every
ported module to it on the same inputs.

Ported so far (the dense component-major LM slice):

- ``geometry``  — SO(3), projection models with analytic Jacobians
- ``problem``   — ``BundleProblem``, robust costs, ``from_numpy``
- ``solver``    — dense-cm Schur LM; ``solver.kernels.proj`` is the
  hand-written CUDA projection/Jacobian kernel (``csrc/``)
- ``pipeline``  — synthetic scenes
- ``utils``     — precision policy, config, timing fences

This package imports ``torch`` and ``numpy`` and never ``jax``.
"""

__version__ = "0.1.0"

from pysfm_tpu_torch import geometry, problem, solver  # noqa: F401
