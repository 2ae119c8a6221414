"""Feature tracks from images: detect, match, verify, link.

Port of :mod:`pysfm_tpu.pipeline.tracks`.  Device side: Harris detection
and patch description of every frame in one batched pass
(``frontend/features.py``), pairwise matching and the fundamental-matrix
RANSAC of each matched pair.  Host side: linking the verified matches into
multi-frame tracks, a small union-find over (frame, keypoint) nodes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from pysfm_tpu_torch.frontend import epipolar, features, match, ransac


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    n_keypoints: int = 512
    patch_radius: int = 5
    min_similarity: float = 0.85
    ratio: float = 0.75
    match_window: int = 3        # match frame f against f-1 .. f-window
    min_track_length: int = 2
    # Geometric verification of every matched pair (fundamental-matrix
    # RANSAC on pixel coords) before linking: wrong matches otherwise
    # contaminate whole tracks through the union-find.
    verify: bool = True
    verify_threshold_px: float = 2.0   # Sampson distance (px)
    verify_hypotheses: int = 128
    min_pair_matches: int = 10
    seed: int = 0


class _UnionFind:
    def __init__(self, n):
        self.parent = np.arange(n)

    def find(self, a):
        root = a
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[a] != root:
            self.parent[a], a = root, self.parent[a]
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def _verify_pair(idx, x1, x2, threshold):
    """Fundamental-matrix RANSAC of one matched pair with the minimal sets
    ``idx [H, 8]``: the inlier mask [n]."""

    def fit(idx_h, w):
        if idx_h is None:   # the all-inlier refit, weighted
            return epipolar.eight_point(x1, x2, w=w)
        return epipolar.eight_point(x1[idx_h], x2[idx_h])

    def score(Fm):
        return epipolar.sampson_distance(Fm, x1, x2)

    return ransac.ransac(idx, x1.shape[0], fit, score, sample_size=8,
                         n_hypotheses=idx.shape[0], threshold=threshold).inliers


def build_tracks(
    images: np.ndarray,          # [F, H, W] grayscale
    config: TrackingConfig = TrackingConfig(),
    *,
    device="cuda",
    sampler: Optional[Callable] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Detect + match + link. Returns ``(uv [F, T, 2], vis [F, T])``.

    Tracks are connected components of the match graph; a component that
    claims two keypoints in the same frame has merged two physical points
    and is dropped entirely (a track that jumps between 3-D points poisons
    triangulation and BA far more than a missing track does).

    Runs on ``device`` (the card unless the caller asks for the CPU).
    ``sampler`` draws the minimal sets of each verified pair's RANSAC, one
    call a pair in the order the pairs are verified, as a callable
    ``(weights [1, n], n_hypotheses, 8) -> idx [1, n_hypotheses, 8]``; the
    default draws from a ``torch.Generator`` on ``device`` seeded with
    ``config.seed``.
    """
    F = images.shape[0]
    N = config.n_keypoints
    device = torch.device(device)
    if sampler is None:
        sampler = ransac.generator_sampler(config.seed, device)
    kp, descs = features.detect_and_describe(
        torch.as_tensor(np.asarray(images), device=device), N,
        patch_radius=config.patch_radius,
    )
    kps = kp.xy.cpu().numpy()
    valids = kp.valid.cpu().numpy()

    uf = _UnionFind(F * N)
    for f in range(1, F):
        for g in range(max(0, f - config.match_window), f):
            m = match.match_descriptors(
                descs[g], descs[f], valid1=kp.valid[g], valid2=kp.valid[f],
                min_similarity=config.min_similarity, ratio=config.ratio,
            )
            ok = m.valid.cpu().numpy()
            i1 = m.idx1.cpu().numpy()[ok]
            i2 = m.idx2.cpu().numpy()[ok]
            if config.verify and len(i1) >= max(8, config.min_pair_matches):
                x1 = torch.as_tensor(kps[g][i1], device=device)
                x2 = torch.as_tensor(kps[f][i2], device=device)
                ones = torch.ones(1, len(i1), dtype=torch.float64, device=device)
                idx = sampler(ones, config.verify_hypotheses, 8)[0]
                keep = _verify_pair(idx, x1, x2, config.verify_threshold_px ** 2)
                keep = keep.cpu().numpy()
                i1, i2 = i1[keep], i2[keep]
            elif config.verify:
                continue  # too few matches to verify: skip the pair
            for a, b in zip(g * N + i1, f * N + i2):
                uf.union(int(a), int(b))

    # Collect components.
    roots = {}
    obs = []  # (track, frame, kp)
    for f in range(F):
        for i in range(N):
            if not valids[f][i]:
                continue
            r = uf.find(f * N + i)
            tid = roots.setdefault(r, len(roots))
            obs.append((tid, f, i))

    T = len(roots)
    uv = np.zeros((F, T, 2))
    vis = np.zeros((F, T), bool)
    conflicted = np.zeros(T, bool)
    for tid, f, i in obs:
        if vis[f, tid]:
            conflicted[tid] = True  # merged component: drop the whole track
            continue
        uv[f, tid] = kps[f][i]
        vis[f, tid] = True

    keep = (vis.sum(axis=0) >= config.min_track_length) & ~conflicted
    return uv[:, keep], vis[:, keep]


def run_from_images(
    images: np.ndarray, intr: np.ndarray, camera_model: str = "pose",
    tracking: TrackingConfig = TrackingConfig(),
    incremental_config=None,
    *,
    device="cuda",
):
    """Full pipeline: images -> tracks -> incremental SfM, on ``device``
    (each stage with its default sampler)."""
    from pysfm_tpu_torch.pipeline.incremental import IncrementalConfig, run_incremental

    uv, vis = build_tracks(images, tracking, device=device)
    cfg = incremental_config or IncrementalConfig()
    return run_incremental(uv, vis, intr, camera_model, cfg, device=device)
