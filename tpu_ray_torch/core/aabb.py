"""Axis-aligned bounding boxes and the ray/box slab test (counterpart of
`tpu_ray/core/aabb.py`): branch-free over ray batches; the uniform grid's
DDA (kernels/dda.py) enters the grid with it."""

from __future__ import annotations

import torch


def ray_aabb(origin: torch.Tensor, inv_dir: torch.Tensor, box_min: torch.Tensor,
             box_max: torch.Tensor):
    """Slab test of (..., 3) rays (inv_dir = safe_inv_dir(d)) against one box.
    Returns (t_enter, t_exit, hit); a ray that starts inside the box enters
    at t = 0."""
    t0 = (box_min - origin) * inv_dir
    t1 = (box_max - origin) * inv_dir
    t_enter = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_exit = torch.amin(torch.maximum(t0, t1), dim=-1)
    t_enter = torch.clamp_min(t_enter, 0.0)
    return t_enter, t_exit, t_exit >= t_enter


def safe_inv_dir(d: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """1/d with the sign of d kept and |d| floored at eps (never inf or NaN)."""
    s = torch.where(d >= 0.0, 1.0, -1.0).to(d.dtype)
    return s / torch.clamp_min(torch.abs(d), eps)
