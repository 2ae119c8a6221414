"""pysfm_tpu_torch — the PyTorch/CUDA port of :mod:`pysfm_tpu`.

Same subpackage and module names as the JAX package, PyTorch idiom inside:
plain functions on tensors, dataclasses of tensors, an explicit ``device=``
wherever a tensor is made, and numpy ``Generator``s for scene randomness.
The JAX package stays the reference; ``tests/test_torch_*.py`` hold every
ported module to it on the same inputs.

Ported so far (the dense routes, the pcg route, the BAL-file path, the
front end and the incremental pipeline, the distributed path):

- ``geometry``  — SO(3), SE(3), projection models with analytic Jacobians
- ``problem``   — ``BundleProblem``, the component-major ``CMProblem``,
  robust costs, ``from_numpy``
- ``solver``    — dense Schur LM (component-major ``schur_cm`` and the
  standard layout ``schur``) and the matrix-free pcg LM;
  ``solver.kernels`` holds the hand-written CUDA kernels (``csrc/``):
  ``proj`` (projection/Jacobian) and ``spmv`` (normal equations, coupling
  rows, cost, the products with Hcp, the block-Jacobi diagonal)
- ``frontend``  — triangulation, the 8-point E/F, batched RANSAC (explicit
  generators or given minimal sets), DLT PnP and P3P, Harris features and
  patch descriptors, matching
- ``io``        — BAL and Bundler files, checkpoints and sharded checkpoints
  (the JAX package's file format), the C++ tokenizer, plots (``viz``)
- ``dist``      — point-sharded distributed BA over ``torch.distributed``:
  the mesh, the collectives, the partition, ``solve_sharded`` and
  ``solve_sharded_cm``, multi-process start-up
- ``pipeline``  — synthetic scenes up to the Venice-scale BAL scene, the
  incremental SfM pipeline and tracking from images
- ``utils``     — precision policy, config, timing fences, metrics, tracing
- ``examples``  — ``python -m pysfm_tpu_torch.examples.distributed_ba``

This package imports ``torch`` and ``numpy`` and never ``jax``.
"""

__version__ = "0.1.0"

from pysfm_tpu_torch import dist, frontend, geometry, io, pipeline, problem, solver  # noqa: F401
