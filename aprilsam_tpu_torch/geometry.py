"""SE(2) geometry on xyt = (x, y, theta) vectors.

PyTorch counterpart of ``aprilsam_tpu/geometry.py`` (reference:
aprilsam/common/doubles_floats_impl.h:497-630 and
aprilsam/common/math_util.h:111-121).  The torch functions broadcast over
leading batch dimensions; the ``np_*`` twins serve host-side code (graph
building, data loading) and are byte-for-byte the JAX package's numpy code.
"""

from __future__ import annotations

import numpy as np
import torch

TWOPI = 2.0 * np.pi


def mod2pi(theta: torch.Tensor) -> torch.Tensor:
    """Map angle to [-pi, pi): mod2pi_positive(v + pi) - pi
    (reference: aprilsam/common/math_util.h:111-121)."""
    v = theta + np.pi
    return (v - TWOPI * torch.floor(v / TWOPI)) - np.pi


def xyt_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose two rigid-body transforms r = a (+) b; theta is not wrapped
    (reference: doubles_floats_impl.h:498-506, s_xyt_mul)."""
    ta = a[..., 2]
    s, c = torch.sin(ta), torch.cos(ta)
    x = c * b[..., 0] - s * b[..., 1] + a[..., 0]
    y = s * b[..., 0] + c * b[..., 1] + a[..., 1]
    return torch.stack([x, y, ta + b[..., 2]], dim=-1)


def xyt_inv(a: torch.Tensor) -> torch.Tensor:
    """Inverse transform (reference: doubles_floats_impl.h:569-575)."""
    s, c = torch.sin(a[..., 2]), torch.cos(a[..., 2])
    x = -s * a[..., 1] - c * a[..., 0]
    y = -c * a[..., 1] + s * a[..., 0]
    return torch.stack([x, y, -a[..., 2]], dim=-1)


def xyt_inv_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """r = inv(a) (+) b, the pose of b in frame a
    (reference: doubles_floats_impl.h:619-630, s_xyt_inv_mul)."""
    theta = a[..., 2]
    ca, sa = torch.cos(theta), torch.sin(theta)
    dx = b[..., 0] - a[..., 0]
    dy = b[..., 1] - a[..., 1]
    return torch.stack(
        [ca * dx + sa * dy, -sa * dx + ca * dy, b[..., 2] - a[..., 2]], dim=-1)


# numpy twins for host-side code paths

def np_mod2pi(theta):
    v = np.asarray(theta, dtype=np.float64) + np.pi
    return (v - TWOPI * np.floor(v / TWOPI)) - np.pi


def np_xyt_mul(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    ta = a[..., 2]
    s, c = np.sin(ta), np.cos(ta)
    return np.stack(
        [
            c * b[..., 0] - s * b[..., 1] + a[..., 0],
            s * b[..., 0] + c * b[..., 1] + a[..., 1],
            ta + b[..., 2],
        ],
        axis=-1,
    )


def np_xyt_inv(a):
    a = np.asarray(a, dtype=np.float64)
    s, c = np.sin(a[..., 2]), np.cos(a[..., 2])
    return np.stack(
        [
            -s * a[..., 1] - c * a[..., 0],
            -c * a[..., 1] + s * a[..., 0],
            -a[..., 2],
        ],
        axis=-1,
    )


def np_xyt_inv_mul(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    theta = a[..., 2]
    ca, sa = np.cos(theta), np.sin(theta)
    dx = b[..., 0] - a[..., 0]
    dy = b[..., 1] - a[..., 1]
    return np.stack(
        [ca * dx + sa * dy, -sa * dx + ca * dy, b[..., 2] - a[..., 2]],
        axis=-1,
    )
