"""Descriptor matching: one matmul, then the ratio and mutual-NN tests.

Port of :mod:`pysfm_tpu.frontend.match`.  The similarity matrix
``d1 @ d2^T`` is the matmul-shaped core; Lowe's ratio test and the mutual
nearest-neighbour check run as elementwise selects on top.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pysfm_tpu_torch.utils import precision as xp


class Matches(NamedTuple):
    idx1: torch.Tensor    # [N1] indices into set 1
    idx2: torch.Tensor    # [N1] indices into set 2
    score: torch.Tensor   # [N1] cosine similarity
    valid: torch.Tensor   # [N1] bool


def match_descriptors(
    d1: torch.Tensor,          # [N1, D] unit-norm
    d2: torch.Tensor,          # [N2, D]
    *,
    valid1: torch.Tensor | None = None,
    valid2: torch.Tensor | None = None,
    min_similarity: float = 0.7,
    ratio: float = 0.9,
    mutual: bool = True,
) -> Matches:
    """Cosine matching with ratio + mutual checks; static [N1] output.

    The ratio test uses distances: for unit descriptors
    ``dist^2 = 2 - 2 sim``, so the test is
    ``(1 - sim_best) < ratio^2 * (1 - sim_second)``.
    """
    sim = xp.matmul(d1, d2.T)                           # [N1, N2]
    minus_one = torch.full_like(sim, -1.0)
    if valid1 is not None:
        sim = torch.where(valid1[:, None], sim, minus_one)
    if valid2 is not None:
        sim = torch.where(valid2[None, :], sim, minus_one)

    top2, top2_idx = torch.topk(sim, 2, dim=-1)         # [N1, 2]
    best, second = top2[:, 0], top2[:, 1]
    idx2 = top2_idx[:, 0]
    ok = best > min_similarity
    ok &= (1.0 - best) < (ratio * ratio) * (1.0 - second)
    arange = torch.arange(d1.shape[0], device=d1.device)
    if mutual:
        back = torch.argmax(sim, dim=0)                 # [N2] best 1 for each 2
        ok &= back[idx2] == arange
    if valid1 is not None:
        ok &= valid1
    return Matches(idx1=arange, idx2=idx2, score=best, valid=ok)
