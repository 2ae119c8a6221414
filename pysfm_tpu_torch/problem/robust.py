"""Robust reprojection cost kernels (IRLS form), port of
:mod:`pysfm_tpu.problem.robust`.

For squared residual norm ``s = ||r||^2`` the robustified cost is
``0.5 * rho(s)`` and the IRLS weight is ``w = rho'(s)`` (first-order IRLS,
no Triggs correction).
"""

from __future__ import annotations

import torch

KERNELS = ("gaussian", "huber", "cauchy")


def _check(kernel: str) -> None:
    if kernel not in KERNELS:
        raise ValueError(f"unknown robust kernel {kernel!r}; expected one of {KERNELS}")


def rho(kernel: str, s: torch.Tensor, scale) -> torch.Tensor:
    """Robust loss of the squared residual s (>= 0). ``scale`` is the knee c."""
    _check(kernel)
    if kernel == "gaussian":
        return s
    c2 = scale * scale
    if kernel == "huber":
        # rho(s) = s for s <= c^2, else 2 c sqrt(s) - c^2
        safe = torch.clamp(s, min=c2)  # only used in the outlier branch
        return torch.where(s <= c2, s, 2.0 * scale * torch.sqrt(safe) - c2)
    # cauchy: c^2 log(1 + s / c^2)
    return c2 * torch.log1p(s / c2)


def weight(kernel: str, s: torch.Tensor, scale) -> torch.Tensor:
    """IRLS weight rho'(s); multiplies J^T J and J^T r blocks."""
    _check(kernel)
    if kernel == "gaussian":
        return torch.ones_like(s)
    c2 = scale * scale
    if kernel == "huber":
        safe = torch.clamp(s, min=c2)
        return torch.where(s <= c2, torch.ones_like(s), scale / torch.sqrt(safe))
    return 1.0 / (1.0 + s / c2)
