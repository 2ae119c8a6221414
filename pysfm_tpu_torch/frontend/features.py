"""Feature detection and description, batched on the device.

Port of :mod:`pysfm_tpu.frontend.features`: a Harris corner response from
a smoothed structure tensor (separable Gaussian convolutions), non-maximum
suppression by max pooling, a fixed-N ``topk`` selection (static shapes;
invalid corners are masked, never dropped), and bias/gain-normalized
intensity patches as descriptors, so matching is one matmul (match.py).

Every function takes one image ``[H, W]`` or a batch of frames
``[F, H, W]`` that runs as one pass; each frame's result is the same as
that of a call on the frame alone.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as tnf

from pysfm_tpu_torch.utils import precision as xp  # noqa: F401  (TF32 off for the convolutions)


def _gaussian_kernel(sigma: float, radius: int, dtype, device=None) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=dtype, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _sep_conv(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Separable 2-D convolution with reflect padding, [..., H, W] ->
    [..., H, W].  The kernel is symmetric, so the cross-correlation of
    ``conv2d`` equals the convolution."""
    r = (k.shape[0] - 1) // 2
    lead = img.shape[:-2]
    x = img.reshape(-1, 1, *img.shape[-2:])
    x = tnf.conv2d(tnf.pad(x, (0, 0, r, r), mode="reflect"), k.reshape(1, 1, -1, 1))
    x = tnf.conv2d(tnf.pad(x, (r, r, 0, 0), mode="reflect"), k.reshape(1, 1, 1, -1))
    return x.reshape(*lead, *x.shape[-2:])


def harris_response(
    img: torch.Tensor, sigma: float = 1.5, k: float = 0.04
) -> torch.Tensor:
    """Harris corner response, [..., H, W]."""
    # Central-difference gradients (wrapping at the border, as jnp.roll).
    gx = 0.5 * (torch.roll(img, -1, dims=-1) - torch.roll(img, 1, dims=-1))
    gy = 0.5 * (torch.roll(img, -1, dims=-2) - torch.roll(img, 1, dims=-2))
    kern = _gaussian_kernel(sigma, int(3 * sigma), img.dtype, img.device)
    sxx = _sep_conv(gx * gx, kern)
    syy = _sep_conv(gy * gy, kern)
    sxy = _sep_conv(gx * gy, kern)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


class Keypoints(NamedTuple):
    xy: torch.Tensor      # [..., N, 2] (x, y) pixel coordinates
    score: torch.Tensor   # [..., N]
    valid: torch.Tensor   # [..., N] bool


def _subpix(c, l, r):
    """1-D quadratic peak offset through (l, c, r), clamped to +-0.5 px."""
    denom = l - 2.0 * c + r
    flat = torch.abs(denom) < 1e-12
    off = 0.5 * (l - r) / torch.where(flat, torch.ones_like(denom), denom)
    return torch.where(flat, torch.zeros_like(off), torch.clamp(off, -0.5, 0.5))


def detect_harris(
    img: torch.Tensor,
    n_keypoints: int = 256,
    *,
    sigma: float = 1.5,
    nms_radius: int = 4,
    border: int = 8,
    rel_threshold: float = 1e-3,
) -> Keypoints:
    """Top-N Harris corners with NMS; static output shape [..., N].

    Missing candidates are -inf and come last; ``topk`` promises no order
    among equal scores, so compare keypoint sets by flat index, not slot.
    """
    resp = harris_response(img, sigma=sigma)
    H, W = resp.shape[-2:]
    lead = resp.shape[:-2]
    flat = resp.reshape(-1, H * W)
    # NMS: keep the local maxima of a (2r+1)^2 window ("SAME" max pooling,
    # -inf beyond the border).
    pooled = tnf.max_pool2d(resp.reshape(-1, 1, H, W), 2 * nms_radius + 1,
                            stride=1, padding=nms_radius).reshape(flat.shape)
    is_max = flat >= pooled
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    in_border = ((yy >= border) & (yy < H - border) & (xx >= border)
                 & (xx < W - border)).reshape(-1)
    thresh = rel_threshold * torch.clamp(torch.amax(flat, dim=-1, keepdim=True), min=1e-12)
    cand = torch.where(is_max & in_border & (flat > thresh), flat,
                       torch.full_like(flat, float("-inf")))
    score, flat_idx = torch.topk(cand, n_keypoints, dim=-1)
    y = flat_idx // W
    x = flat_idx % W

    def at(yi, xi):
        return torch.gather(flat, -1, yi * W + xi)

    rc = at(y, x)
    dx = _subpix(rc, at(y, torch.clamp(x - 1, min=0)), at(y, torch.clamp(x + 1, max=W - 1)))
    dy = _subpix(rc, at(torch.clamp(y - 1, min=0), x), at(torch.clamp(y + 1, max=H - 1), x))
    xy = torch.stack([x + dx, y + dy], dim=-1).to(img.dtype)
    score = score.reshape(*lead, n_keypoints)
    return Keypoints(xy=xy.reshape(*lead, n_keypoints, 2), score=score,
                     valid=torch.isfinite(score))


def describe_patches(
    img: torch.Tensor, kps: Keypoints, patch_radius: int = 5
) -> torch.Tensor:
    """Bias/gain-normalized intensity patches as descriptors, sampled
    bilinearly at the keypoint's SUBPIXEL location (rounding shifts the
    patch by up to 0.5 px, which decorrelates NCC on fine texture).

    [..., N, (2r+1)^2], unit-norm rows: cosine similarity is the normalized
    cross correlation, so matching is one matmul.
    """
    H, W = img.shape[-2:]
    offs = torch.arange(-patch_radius, patch_radius + 1, dtype=img.dtype, device=img.device)
    xs = torch.clamp(kps.xy[..., 0, None] + offs, 0.0, W - 1.001)   # [..., N, d]
    ys = torch.clamp(kps.xy[..., 1, None] + offs, 0.0, H - 1.001)
    x0 = torch.floor(xs).to(torch.int64)
    y0 = torch.floor(ys).to(torch.int64)
    fx = (xs - x0)[..., None, :]                                     # [..., N, 1, d]
    fy = (ys - y0)[..., :, None]                                     # [..., N, d, 1]
    flat = img.reshape(*img.shape[:-2], 1, H * W)

    def at(yi, xi):  # [..., N, d, d] pixel values
        ids = yi[..., :, None] * W + xi[..., None, :]
        return torch.take_along_dim(flat, ids.flatten(-2), dim=-1).reshape(ids.shape)

    patch = (at(y0, x0) * (1 - fy) * (1 - fx)
             + at(y0, x0 + 1) * (1 - fy) * fx
             + at(y0 + 1, x0) * fy * (1 - fx)
             + at(y0 + 1, x0 + 1) * fy * fx).flatten(-2)
    patch = patch - torch.mean(patch, dim=-1, keepdim=True)
    norm = torch.linalg.norm(patch, dim=-1, keepdim=True)
    return patch / torch.clamp(norm, min=1e-8)


def detect_and_describe(
    img: torch.Tensor,
    n_keypoints: int = 256,
    patch_radius: int = 5,
    describe_sigma: float = 0.8,
    **kw,
) -> Tuple[Keypoints, torch.Tensor]:
    """Detect on the raw image; describe on a lightly blurred copy
    (``describe_sigma`` > 0) so sub-pixel shifts decorrelate NCC less."""
    kps = detect_harris(img, n_keypoints, **kw)
    if describe_sigma > 0:
        k = _gaussian_kernel(describe_sigma, max(2, int(3 * describe_sigma)),
                             img.dtype, img.device)
        img = _sep_conv(img, k)
    return kps, describe_patches(img, kps, patch_radius)
