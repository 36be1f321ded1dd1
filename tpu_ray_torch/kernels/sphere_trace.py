"""Sphere tracing as a lockstep masked march, and the SDF surface normal
(counterpart of `tpu_ray/kernels/sphere_trace.py`).

`march` is the reference's batch march: every ray takes the same step count
and converged rays are frozen by masks. The renderer's march is the kernel
in `cuda_sdf.py`, which adds a bounding-sphere cull; the two agree on `hit`
and on `t` where they hit. The implicit-function gradient at the hit comes
with the backward slice.
"""

from __future__ import annotations

from typing import Callable

import torch


def march(de_fn: Callable, scene, o, d, *, t0, max_steps: int, eps: float,
          t_far: float):
    """Forward march -> (t, hit, steps, t_min).

    de_fn(scene, p): (..., 3) -> (...,). t_min is the ray parameter of the
    smallest DE seen (the closest approach, for soft silhouettes).
    """
    shape = o.shape[:-1]
    t = torch.full(shape, float(t0), dtype=o.dtype, device=o.device)
    hit = torch.zeros(shape, dtype=torch.bool, device=o.device)
    steps = torch.zeros(shape, dtype=torch.int32, device=o.device)
    dmin = torch.full(shape, 1e10, dtype=o.dtype, device=o.device)
    tmin = t.clone()
    for _ in range(max_steps):
        active = (~hit) & (t < t_far)
        dist = de_fn(scene, o + t[..., None] * d)
        closer = active & (dist < dmin)
        dmin = torch.where(closer, dist, dmin)
        tmin = torch.where(closer, t, tmin)
        hit_now = active & (dist < eps)
        hit = hit | hit_now
        t = torch.where(active & (~hit_now), t + dist, t)
        steps = steps + active.to(torch.int32)
    return t, hit, steps, tmin


def surface_normal(de_fn: Callable, scene, p: torch.Tensor) -> torch.Tensor:
    """Unit normal = normalized grad_p DE, batched over rays.

    Runs under `torch.enable_grad()` because the geometry pass runs under
    `no_grad`. Each DE output depends only on its own point, so one backward
    with a ones cotangent gives every per-row gradient. Values only: `p` is
    detached (the backward slice adds `create_graph` for the Hessian term).
    """
    with torch.enable_grad():
        pp = p.detach().requires_grad_(True)
        (grad_p,) = torch.autograd.grad(de_fn(scene, pp).sum(), pp)
    n2 = torch.sum(grad_p * grad_p, dim=-1, keepdim=True)
    return grad_p / torch.sqrt(torch.clamp_min(n2, 1e-12))
