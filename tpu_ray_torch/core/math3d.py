"""3D vector helpers on tensors whose last axis is xyz.

Counterpart of `tpu_ray/core/math3d.py`. Dot products are written out per
component, in the order the CUDA kernels use, so a kernel and its plain
PyTorch version round identically.
"""

from __future__ import annotations

import torch

# keeps sqrt and division finite for zero-length vectors
_EPS = 1e-12


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3), (..., 3) -> (...,)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def normalize(a: torch.Tensor) -> torch.Tensor:
    return a / torch.sqrt(torch.clamp_min(dot(a, a), _EPS))[..., None]


def clamp01(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0)
