"""Möller–Trumbore ray/triangle intersection, batched and masked
(counterpart of `tpu_ray/kernels/moller_trumbore.py`).

`intersect_brute` is the oracle: every ray against every triangle, closest
valid hit by masked min. `recompute_hit_corners` re-solves the selected
triangle from its corners; the renderer uses it to rebuild hit state from
the packet kernel's triangle ids.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_ray_torch.core.math3d import cross, dot, normalize
from tpu_ray_torch.scene.mesh import MeshScene

_DET_EPS = 1e-10
_T_MIN = 1e-5
BIG = 1e10


class TriHit(NamedTuple):
    t: torch.Tensor  # (R,) hit distance (BIG where no hit)
    tri: torch.Tensor  # (R,) int32 triangle index (-1 where no hit)
    hit: torch.Tensor  # (R,) bool


def _mt_t(o, d, v0, v1, v2, t_max):
    """Raw two-sided MT test for broadcastable batches -> (t, valid)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    ok = torch.abs(det) > _DET_EPS
    inv_det = torch.where(ok, 1.0 / det, torch.zeros_like(det))
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    valid = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > _T_MIN) & (t < t_max))
    return torch.where(valid, t, torch.full_like(t, BIG)), valid


def intersect_brute(mesh: MeshScene, o: torch.Tensor, d: torch.Tensor,
                    t_max: float = BIG) -> TriHit:
    """Closest hit over all triangles: (R, T) masked min, first index on ties."""
    shape = o.shape[:-1]
    if mesh.num_tris == 0:
        return TriHit(torch.full(shape, BIG, dtype=o.dtype, device=o.device),
                      torch.full(shape, -1, dtype=torch.int32, device=o.device),
                      torch.zeros(shape, dtype=torch.bool, device=o.device))
    v0, v1, v2 = mesh.triangle_corners()
    t, valid = _mt_t(o[..., None, :], d[..., None, :], v0, v1, v2, t_max)
    t_best, tri = torch.min(t, dim=-1)
    hit = torch.gather(valid, -1, tri[..., None])[..., 0]
    tri = tri.to(torch.int32)
    return TriHit(t_best, torch.where(hit, tri, torch.full_like(tri, -1)), hit)


def any_hit_brute(mesh: MeshScene, o, d, t_max: float = BIG) -> torch.Tensor:
    """Occlusion query: does any triangle block within t_max?"""
    return intersect_brute(mesh, o, d, t_max=t_max).hit


def recompute_hit_corners(v0, v1, v2, o, d):
    """(t, u, v, n_geom) of the selected triangles from gathered corners."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    det_safe = torch.where(torch.abs(det) > _DET_EPS, det,
                           torch.where(det >= 0, _DET_EPS, -_DET_EPS).to(det.dtype))
    inv_det = 1.0 / det_safe
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    n = normalize(cross(e1, e2))
    return t, u, v, n


def edge_margin_corners(v0, v1, v2, u, v):
    """World-space in-plane distance from the hit to the nearest triangle
    edge: barycentric weight b_i times the height 2A / L_i over edge i."""
    e1 = v1 - v0
    e2 = v2 - v0
    cn = cross(e1, e2)
    two_area = torch.sqrt(torch.clamp_min(dot(cn, cn), 1e-24))
    l0 = torch.sqrt(torch.clamp_min(dot(v2 - v1, v2 - v1), 1e-24))
    l1 = torch.sqrt(torch.clamp_min(dot(e2, e2), 1e-24))
    l2 = torch.sqrt(torch.clamp_min(dot(e1, e1), 1e-24))
    d0 = (1.0 - u - v) * two_area / l0
    d1 = u * two_area / l1
    d2 = v * two_area / l2
    return torch.minimum(d0, torch.minimum(d1, d2))
