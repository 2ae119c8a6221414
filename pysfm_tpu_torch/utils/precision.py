"""f32-exact contraction helpers.

The JAX package pins every contraction that feeds the optimizer state to
``Precision.HIGHEST`` because the TPU's default matmul rounds f32 operands
to bf16.  The card's counterpart is TF32: an f32 matmul or convolution that
may run on the tensor cores keeps about three decimal digits, which shifts
the LM fixed point exactly as bf16 did.  PyTorch leaves TF32 off for CUDA
matmuls by default but on for cuDNN convolutions, and any caller may flip
either flag; importing this module sets both off so the solver's
contractions (normal equations, Schur products, 3x3 geometry chains) stay
full f32 on the card.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def einsum(subscripts: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in full f32 (TF32 is off, see the module note)."""
    return torch.einsum(subscripts, *operands)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` in full f32."""
    return torch.matmul(a, b)


def matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched ``A @ x`` for [..., m, n] @ [..., n]."""
    return torch.matmul(A, x.unsqueeze(-1)).squeeze(-1)
