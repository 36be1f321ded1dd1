"""Mesh generators, frozen copies of tpu_ray_torch/scene/mesh.py:205-241
(`ground_plane_quad`, `torus_knot`, `normalize_to_unit`) at commit
c4adc4a. Host numpy; a configuration names a generator and its
arguments."""

from __future__ import annotations

import numpy as np


def normalize_to_unit(verts: np.ndarray, target_half: float = 1.0) -> np.ndarray:
    """Center at the origin and scale the longest half-extent to target_half."""
    lo, hi = verts.min(0), verts.max(0)
    center = 0.5 * (lo + hi)
    half = 0.5 * (hi - lo).max()
    return (verts - center) * (target_half / max(half, 1e-12))


def ground_quad(y: float, half: float):
    """Two triangles forming a square ground plane at height y, facing +y."""
    v = np.array([[-half, y, -half], [half, y, -half], [half, y, half], [-half, y, half]],
                 np.float64)
    return v, np.array([[0, 2, 1], [0, 3, 2]], np.int32)


def torus_knot(p: int = 2, q: int = 3, seg_u: int = 187, seg_v: int = 187,
               radius: float = 0.6, tube: float = 0.22):
    """Closed tube around a (p, q) torus knot: 2 * seg_u * seg_v triangles."""
    u = np.linspace(0, 2 * np.pi, seg_u, endpoint=False)
    r = radius * (2 + np.cos(q * u)) * 0.5
    c = np.stack([r * np.cos(p * u), r * np.sin(p * u), radius * 0.5 * np.sin(q * u)], -1)
    t = np.roll(c, -1, 0) - np.roll(c, 1, 0)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    n = np.cross(t, np.array([0.0, 0.0, 1.0]))
    bad = np.linalg.norm(n, axis=-1) < 1e-6
    n[bad] = np.cross(t[bad], [1.0, 0.0, 0.0])
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    b = np.cross(t, n)
    v = np.linspace(0, 2 * np.pi, seg_v, endpoint=False)
    circ = np.cos(v)[None, :, None] * n[:, None, :] + np.sin(v)[None, :, None] * b[:, None, :]
    verts = (c[:, None, :] + tube * circ).reshape(-1, 3)
    grid = np.arange(seg_u)[:, None] * seg_v + np.arange(seg_v)[None, :]
    gu = np.roll(grid, -1, 0)
    gv = np.roll(grid, -1, 1)
    guv = np.roll(gu, -1, 1)
    f0 = np.stack([grid, gu, guv], -1).reshape(-1, 3)
    f1 = np.stack([grid, guv, gv], -1).reshape(-1, 3)
    return verts, np.concatenate([f0, f1]).astype(np.int32)


GENERATORS = {"torus_knot": torus_knot, "ground_quad": ground_quad}


def build(entry: dict):
    """One mesh of a configuration's `meshes` list -> (verts, tris, mat):
    the generator's mesh, scaled to a unit half-extent if `unit`, then
    times `scale`, plus `offset`."""
    verts, tris = GENERATORS[entry["generator"]](**entry.get("args", {}))
    if entry.get("unit"):
        verts = normalize_to_unit(verts)
    verts = entry.get("scale", 1.0) * verts + np.asarray(entry.get("offset", (0.0, 0.0, 0.0)))
    return verts, tris, int(entry["mat"])
