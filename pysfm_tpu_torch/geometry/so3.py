"""SO(3) — rotation group operations, batched.

Port of :mod:`pysfm_tpu.geometry.so3`: Rodrigues exp with the small-angle
Taylor branch, quaternion-based log, and SVD re-orthonormalization.  All
functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import torch

from pysfm_tpu_torch.utils import precision as xp

# Below this squared angle the Rodrigues coefficients switch to their
# Taylor expansions (the same threshold as the JAX package).
_SMALL_SQ = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of w: hat(w) @ v == cross(w, v).
    [..., 3] -> [..., 3, 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    rows = [
        torch.stack([zero, -wz, wy], dim=-1),
        torch.stack([wz, zero, -wx], dim=-1),
        torch.stack([-wy, wx, zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: [..., 3, 3] -> [..., 3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _exp_coefs(theta_sq: torch.Tensor):
    """Rodrigues coefficients A = sin(t)/t, B = (1-cos(t))/t^2, small-angle safe."""
    small = theta_sq < _SMALL_SQ
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    a_exact = torch.sin(theta) / theta
    b_exact = (1.0 - torch.cos(theta)) / safe_sq
    a_taylor = 1.0 - theta_sq / 6.0 * (1.0 - theta_sq / 20.0)
    b_taylor = 0.5 - theta_sq / 24.0 * (1.0 - theta_sq / 30.0)
    return torch.where(small, a_taylor, a_exact), torch.where(small, b_taylor, b_exact)


def exp(w: torch.Tensor) -> torch.Tensor:
    """SO(3) exponential map (Rodrigues): [..., 3] -> [..., 3, 3]."""
    theta_sq = torch.sum(w * w, dim=-1)
    a, b = _exp_coefs(theta_sq)
    W = hat(w)
    WW = xp.matmul(W, W)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * W + b[..., None, None] * WW


def to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion [w, x, y, z], Shepperd's method
    (branch-free: all four candidates, the best-conditioned one selected).
    [..., 3, 3] -> [..., 4]."""
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    t0 = 1.0 + r00 + r11 + r22
    t1 = 1.0 + r00 - r11 - r22
    t2 = 1.0 - r00 + r11 - r22
    t3 = 1.0 - r00 - r11 + r22
    q0 = torch.stack([t0, r21 - r12, r02 - r20, r10 - r01], dim=-1)
    q1 = torch.stack([r21 - r12, t1, r01 + r10, r02 + r20], dim=-1)
    q2 = torch.stack([r02 - r20, r01 + r10, t2, r12 + r21], dim=-1)
    q3 = torch.stack([r10 - r01, r02 + r20, r12 + r21, t3], dim=-1)

    ts = torch.stack([t0, t1, t2, t3], dim=-1)
    k = torch.argmax(ts, dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)            # [..., 4 cases, 4]
    idx = k[..., None, None].expand(*k.shape, 1, 4)
    q = torch.gather(qs, -2, idx)[..., 0, :]
    tk = torch.gather(ts, -1, k[..., None])
    q = q / (2.0 * torch.sqrt(torch.clamp(tk, min=1e-30)))
    # Canonical hemisphere: w >= 0 so theta = 2*atan2(|v|, w) lies in [0, pi].
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def from_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [w, x, y, z] -> rotation matrix. [..., 4] -> [..., 3, 3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        torch.stack(
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            dim=-1,
        ),
        torch.stack(
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            dim=-1,
        ),
        torch.stack(
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            dim=-1,
        ),
    ]
    return torch.stack(rows, dim=-2)


def log(R: torch.Tensor) -> torch.Tensor:
    """SO(3) logarithm: [..., 3, 3] -> [..., 3] axis-angle vector, through
    the quaternion so it stays accurate at every angle."""
    q = to_quaternion(R)
    w, v = q[..., 0], q[..., 1:]
    n = torch.linalg.norm(v, dim=-1)
    theta = 2.0 * torch.atan2(n, w)
    small = n < 1e-9
    safe_n = torch.where(small, torch.ones_like(n), n)
    # theta/n -> 2/w as n -> 0 (w -> 1 on the canonical hemisphere).
    scale = torch.where(small, 2.0 / torch.clamp(w, min=1e-12), theta / safe_n)
    return scale[..., None] * v


def normalize(R: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize a near-rotation matrix via symmetric polar
    projection (fights f32 drift of ``R <- exp(dw) @ R``)."""
    u, _, vt = torch.linalg.svd(R)
    det = torch.linalg.det(xp.matmul(u, vt))
    # Flip the last singular direction if the product would be a reflection.
    fix = torch.cat([torch.ones_like(R[..., :2, 0]), det[..., None]], dim=-1)
    return xp.matmul(u * fix[..., None, :], vt)
