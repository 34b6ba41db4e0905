"""Closed-form batched 3x3 linear algebra for the hot path (PyTorch
counterpart of ``aprilsam_tpu/kernels/linalg3.py``): unrolled elementwise
forms, where a general batched Cholesky or triangular solve would pay a
library call's fixed cost for 3x3 work."""

from __future__ import annotations

import torch


def chol3(W: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Batched UPPER factor R with R^T R = W for symmetric PSD W[..., 3, 3]
    (reads the upper triangle only).  `jitter` (relative to the diagonal
    scale) regularizes PSD-singular inputs; zero matrices map to ~zero
    factors."""
    eps = jitter + 1e-30
    w00 = W[..., 0, 0]
    w01 = W[..., 0, 1]
    w02 = W[..., 0, 2]
    w11 = W[..., 1, 1]
    w12 = W[..., 1, 2]
    w22 = W[..., 2, 2]
    scale = w00 + w11 + w22
    # dtype-aware positive floor: a literal like 1e-300 underflows to 0 in
    # float32 and turns the zero-W case into 0/0
    tiny = torch.finfo(W.dtype).tiny
    d0 = torch.clamp(w00 + eps * scale, min=tiny)
    l00 = torch.sqrt(d0)
    l01 = w01 / l00
    l02 = w02 / l00
    d1 = torch.clamp(w11 + eps * scale - l01 * l01, min=tiny)
    l11 = torch.sqrt(d1)
    l12 = (w12 - l01 * l02) / l11
    d2 = torch.clamp(w22 + eps * scale - l02 * l02 - l12 * l12, min=tiny)
    l22 = torch.sqrt(d2)
    z = torch.zeros_like(l00)
    return torch.stack([
        torch.stack([l00, l01, l02], dim=-1),
        torch.stack([z, l11, l12], dim=-1),
        torch.stack([z, z, l22], dim=-1),
    ], dim=-2)


def solve_upper3(R: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched solve R x = b for upper-triangular R[..., 3, 3], b[..., 3]."""
    x2 = b[..., 2] / R[..., 2, 2]
    x1 = (b[..., 1] - R[..., 1, 2] * x2) / R[..., 1, 1]
    x0 = (b[..., 0] - R[..., 0, 1] * x1 - R[..., 0, 2] * x2) / R[..., 0, 0]
    return torch.stack([x0, x1, x2], dim=-1)
