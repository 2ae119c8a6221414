"""Block normal equations helpers shared by the Schur solvers.

Port of the part of :mod:`pysfm_tpu.solver.schur` that the component-major
path uses; the standard-layout solver itself is not ported yet.
"""

from __future__ import annotations

import torch


def augment_block_diag(H: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """LM damping: H + lam * diag(H), with unit fill on exactly-zero diagonal
    entries (gauge-fixed cameras / unobserved or padding points) so the block
    stays invertible; those blocks have zero gradient, hence zero step."""
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    fill = torch.where(d == 0, torch.ones_like(d), torch.zeros_like(d))
    aug = lam * d + fill
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return H + aug[..., :, None] * eye
