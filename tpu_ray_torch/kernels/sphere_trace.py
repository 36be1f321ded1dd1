"""Sphere tracing as a lockstep masked march, the implicit-function gradient
at the hit, and the SDF surface normal (counterpart of
`tpu_ray/kernels/sphere_trace.py`).

`march` is the reference's batch march: every ray takes the same step count
and converged rays are frozen by masks. The renderer's march is the kernel
in `cuda_sdf.py`, which adds a bounding-sphere cull; the two agree on `hit`
and on `t` where they hit. `IftAttach` gives that non-differentiated march
result its gradient.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.autograd.function import once_differentiable

from tpu_ray_torch.core.math3d import dot

_DENOM_MIN = 1e-6  # clamp of the IFT denominator dDE/dt


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


class IftAttach(torch.autograd.Function):
    """t = attach(de_fn, sdf, o, d, t_bar, hit_f, *sdf.float_leaves()).

    Its value is the march result t_bar; its gradient is the implicit-
    function pullback at the hit point p = o + t_bar d:
    dt/d(theta, o, d) = -dDE/d(theta, o, d) / <grad_p DE(p), d>, with the
    denominator clamped away from 0 by _DENOM_MIN, and zero where hit_f is
    0 (counterpart of `make_ift_attach`). The fixed-point march runs once,
    outside autograd; the gradient costs two DE gradients at the hit.
    """

    @staticmethod
    def forward(ctx, de_fn, sdf, o, d, t_bar, hit_f, *leaves):
        ctx.de_fn = de_fn
        ctx.sdf = sdf.with_float_leaves([x.detach() for x in leaves])
        ctx.save_for_backward(o, d, t_bar, hit_f)
        return t_bar.clone()

    @staticmethod
    @once_differentiable
    def backward(ctx, ct_t):
        o, d, t_bar, hit_f = ctx.saved_tensors
        de_fn, sdf = ctx.de_fn, ctx.sdf
        want = ctx.needs_input_grad
        with torch.enable_grad():
            # the denominator as the reference's kernel takes it: one
            # gradient of the DE at p, dotted with d
            p = (o + t_bar[..., None] * d).detach().requires_grad_(True)
            (g,) = torch.autograd.grad(de_fn(sdf, p).sum(), p)
            denom = dot(g, d)
            denom_safe = torch.where(
                torch.abs(denom) < _DENOM_MIN,
                torch.where(denom < 0, -_DENOM_MIN, _DENOM_MIN).to(denom.dtype),
                denom)
            scale = torch.where(hit_f > 0.5, -ct_t / denom_safe,
                                torch.zeros_like(ct_t))
            # the numerator: pull scale back through DE(o + t_bar d; theta)
            args = [x.detach().requires_grad_(bool(w and x.numel()))
                    for x, w in zip((o, d, *sdf.float_leaves()),
                                    (want[2], want[3], *want[6:]))]
            o_, d_, leaves = args[0], args[1], args[2:]
            value = de_fn(sdf.with_float_leaves(leaves), o_ + t_bar[..., None] * d_)
            inputs = [x for x in args if x.requires_grad]
            grads = iter(torch.autograd.grad(value, inputs, grad_outputs=scale,
                                             allow_unused=True) if inputs else ())
            out = [next(grads) if x.requires_grad else None for x in args]
        return (None, None, out[0], out[1], None, None, *out[2:])


def surface_normal(de_fn: Callable, scene, p: torch.Tensor,
                   create_graph: bool = False) -> torch.Tensor:
    """Unit normal = normalized grad_p DE, batched over rays.

    Each DE output depends only on its own point, so one backward with a
    ones cotangent gives every per-row gradient. With create_graph (for a p
    that requires grad) the gradient stays differentiable with respect to p
    and the scene: the DE Hessian term of the shade's backward. Otherwise
    `p` is detached and the normal is values only (the geometry pass, which
    runs under `no_grad`).
    """
    with torch.enable_grad():
        pp = p if create_graph else p.detach().requires_grad_(True)
        (grad_p,) = torch.autograd.grad(de_fn(scene, pp).sum(), pp,
                                        create_graph=create_graph)
    n2 = torch.sum(grad_p * grad_p, dim=-1, keepdim=True)
    return grad_p / torch.sqrt(torch.clamp_min(n2, 1e-12))
