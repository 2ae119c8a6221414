"""Batched RANSAC: every hypothesis fitted and scored in parallel.

Port of :mod:`pysfm_tpu.frontend.ransac`.  The JAX package draws the
minimal sets inside ``ransac`` from a ``jax.random`` key; here the draw is
its own function (:func:`sample_indices`, Gumbel-top-k on a
``torch.Generator``), and ``ransac`` takes either a generator or the sample
indices themselves, so a caller can fit exactly the minimal sets another
implementation drew.  Leading batch dimensions (one RANSAC problem per
frame pair or frame) run in the same dispatch.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class RansacResult(NamedTuple):
    model: torch.Tensor           # best (possibly refit) model
    inliers: torch.Tensor         # [..., N] bool
    n_inliers: torch.Tensor       # [...]
    best_hypothesis: torch.Tensor  # [...] index of the winning minimal set


def sample_indices(
    gen: torch.Generator, weights: torch.Tensor, n_hypotheses: int, k: int,
) -> torch.Tensor:
    """``k`` distinct indices per hypothesis, drawn without replacement with
    probabilities ``weights / sum(weights)`` (Gumbel-top-k, one batched
    draw on the generator's device).  ``weights [..., N]`` ->
    ``[..., n_hypotheses, k]`` int64; zero-weight entries are never drawn
    while k entries have a positive weight."""
    w = weights.to(gen.device, torch.float64)
    u = torch.rand((*w.shape[:-1], n_hypotheses, w.shape[-1]), generator=gen,
                   dtype=torch.float64, device=gen.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-300)))
    logp = torch.log(w / torch.sum(w, dim=-1, keepdim=True))
    return torch.topk(logp[..., None, :] + gumbel, k, dim=-1).indices


def generator_sampler(seed: int, device="cuda") -> Callable:
    """The default sampler of the pipelines: a callable
    ``(weights [B, N], n_hypotheses, k) -> idx [B, n_hypotheses, k]``
    drawing from one ``torch.Generator`` on ``device`` seeded with
    ``seed``, call after call."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def sample(weights: torch.Tensor, n_hypotheses: int, k: int) -> torch.Tensor:
        return sample_indices(gen, weights, n_hypotheses, k)

    return sample


def _take(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``x`` at hypothesis ``k`` of each batch entry: the hypothesis axis is
    dim ``k.dim()`` of ``x``, and it is removed."""
    b = k.dim()
    index = k.reshape(*k.shape, *([1] * (x.dim() - b)))
    return torch.take_along_dim(x, index, dim=b).squeeze(b)


def ransac(
    rng: torch.Generator | torch.Tensor,
    n_data: int,
    fit: Callable,            # (idx [..., H, k] | None, w [..., H, N]) -> models [..., H, ...]
    score: Callable,          # (models [..., H, ...]) -> residual^2 [..., H, N]
    *,
    sample_size: int,
    n_hypotheses: int = 256,
    threshold: float = 1e-2,
    refit: bool = True,
    data_weights: torch.Tensor | None = None,
) -> RansacResult:
    """Generic batched RANSAC.

    ``rng`` is a ``torch.Generator`` to draw the minimal sets from, or the
    sample indices ``[..., n_hypotheses, sample_size]`` themselves.
    ``data_weights [..., N]`` (default: ones, f64 on ``rng``'s device)
    weight the draw and mask the inliers.  ``fit`` receives the indices of
    the minimal samples and their 0/1 weight vectors over all data, or
    ``None`` and the all-inlier weights ``[..., 1, N]`` for the final
    refit, so weighted solvers serve both.  ``score`` returns squared
    residuals of every datum under each model.  A hypothesis whose
    residuals are not all finite scores -1; the first maximum of the inlier
    counts wins, and the refit replaces it only if its residuals are finite
    and it keeps at least as many inliers.
    """
    if data_weights is None:
        data_weights = torch.ones(n_data, dtype=torch.float64, device=rng.device)
    if isinstance(rng, torch.Generator):
        idx = sample_indices(rng, data_weights, n_hypotheses, sample_size)
    else:
        idx = rng
    idx = idx.to(data_weights.device, torch.int64)
    w = torch.zeros((*idx.shape[:-1], n_data), dtype=data_weights.dtype,
                    device=data_weights.device)
    w.scatter_(-1, idx, 1.0)
    models = fit(idx, w)
    res = score(models)                                        # [..., H, N]
    finite = torch.all(torch.isfinite(res), dim=-1)
    inls = (res < threshold) & (data_weights[..., None, :] > 0)
    counts = torch.where(finite, torch.sum(inls, dim=-1), -1)
    best = torch.argmax(counts, dim=-1)                        # first maximum
    model = _take(models, best)
    inliers = _take(inls, best)

    if refit:
        w_in = (inliers.to(data_weights.dtype) * data_weights).unsqueeze(-2)
        fitted = fit(None, w_in)                               # [..., 1, ...]
        res = score(fitted).squeeze(-2)
        model_refit = fitted.squeeze(best.dim())
        inl_refit = (res < threshold) & (data_weights > 0)
        better = torch.all(torch.isfinite(res), dim=-1) & (
            torch.sum(inl_refit, dim=-1) >= torch.sum(inliers, dim=-1))
        model = torch.where(better.reshape(*better.shape, *([1] * (model.dim() - better.dim()))),
                            model_refit, model)
        inliers = torch.where(better[..., None], inl_refit, inliers)

    return RansacResult(model=model, inliers=inliers,
                        n_inliers=torch.sum(inliers, dim=-1), best_hypothesis=best)
