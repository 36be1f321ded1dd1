"""Triangle meshes: the tensor container and the host-side numpy generators.

Counterpart of `tpu_ray/scene/mesh.py`. The generators are copies of the
reference's numpy code (that module imports jax), so both packages build
bit-identical meshes. Normals are geometric, computed at hit time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class MeshScene:
    verts: torch.Tensor  # (V, 3) float
    tris: torch.Tensor  # (T, 3) int32 vertex indices
    tri_mat: torch.Tensor  # (T,) int32 material ids

    @property
    def num_tris(self) -> int:
        return self.tris.shape[0]

    @staticmethod
    def empty(device="cpu", dtype=torch.float32) -> "MeshScene":
        return MeshScene(
            verts=torch.zeros((0, 3), dtype=dtype, device=device),
            tris=torch.zeros((0, 3), dtype=torch.int32, device=device),
            tri_mat=torch.zeros((0,), dtype=torch.int32, device=device),
        )

    @staticmethod
    def from_numpy(verts: np.ndarray, tris: np.ndarray, mat_id=0,
                   device="cpu", dtype=torch.float32) -> "MeshScene":
        t = np.asarray(tris, np.int32).reshape(-1, 3)
        mats = (np.full((t.shape[0],), mat_id, np.int32) if np.isscalar(mat_id)
                else np.asarray(mat_id, np.int32))
        return MeshScene(
            verts=torch.as_tensor(np.asarray(verts, np.float64), dtype=dtype,
                                  device=device),
            tris=torch.as_tensor(t, device=device),
            tri_mat=torch.as_tensor(mats, device=device),
        )

    def triangle_corners(self):
        """Per-triangle corner positions: three (T, 3) tensors."""
        v, t = self.verts, self.tris.long()
        return v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]


def concat_meshes(a: MeshScene, b: MeshScene) -> MeshScene:
    return MeshScene(
        verts=torch.cat([a.verts, b.verts]),
        tris=torch.cat([a.tris, b.tris + a.verts.shape[0]]),
        tri_mat=torch.cat([a.tri_mat, b.tri_mat]),
    )


# ---------------------------------------------------------------------------
# Generators (host-side numpy, copied from the reference)
# ---------------------------------------------------------------------------

def normalize_to_unit(verts: np.ndarray, target_half: float = 1.0) -> np.ndarray:
    """Center at origin and scale the longest half-extent to target_half."""
    lo, hi = verts.min(0), verts.max(0)
    center = 0.5 * (lo + hi)
    half = 0.5 * (hi - lo).max()
    return (verts - center) * (target_half / max(half, 1e-12))


def ground_plane_quad(y: float, half: float) -> tuple[np.ndarray, np.ndarray]:
    """Two large triangles forming a square ground plane at height y."""
    v = np.array(
        [[-half, y, -half], [half, y, -half], [half, y, half], [-half, y, half]],
        np.float64,
    )
    f = np.array([[0, 2, 1], [0, 3, 2]], np.int32)  # wound to face +y
    return v, f


def torus_knot(p: int = 2, q: int = 3, seg_u: int = 187, seg_v: int = 187,
               radius: float = 0.6, tube: float = 0.22) -> tuple[np.ndarray, np.ndarray]:
    """Closed tube mesh around a (p, q) torus knot: 2 * seg_u * seg_v triangles."""
    u = np.linspace(0, 2 * np.pi, seg_u, endpoint=False)
    r = radius * (2 + np.cos(q * u)) * 0.5
    cx = r * np.cos(p * u)
    cy = r * np.sin(p * u)
    cz = radius * 0.5 * np.sin(q * u)
    c = np.stack([cx, cy, cz], -1)
    t = np.roll(c, -1, 0) - np.roll(c, 1, 0)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    ref = np.array([0.0, 0.0, 1.0])
    n = np.cross(t, ref)
    bad = np.linalg.norm(n, axis=-1) < 1e-6
    n[bad] = np.cross(t[bad], [1.0, 0.0, 0.0])
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    b = np.cross(t, n)
    v = np.linspace(0, 2 * np.pi, seg_v, endpoint=False)
    circ = np.cos(v)[None, :, None] * n[:, None, :] + np.sin(v)[None, :, None] * b[:, None, :]
    verts = (c[:, None, :] + tube * circ).reshape(-1, 3)
    iu = np.arange(seg_u)
    iv = np.arange(seg_v)
    grid = (iu[:, None] * seg_v + iv[None, :])
    gu = np.roll(grid, -1, 0)
    gv = np.roll(grid, -1, 1)
    guv = np.roll(gu, -1, 1)
    f0 = np.stack([grid, gu, guv], -1).reshape(-1, 3)
    f1 = np.stack([grid, guv, gv], -1).reshape(-1, 3)
    return verts, np.concatenate([f0, f1]).astype(np.int32)


def bunny_standin(target_tris: int = 69938) -> tuple[np.ndarray, np.ndarray]:
    """~70k-triangle (2,3) torus-knot tube standing in for the Stanford bunny,
    scaled to a unit half-extent."""
    seg = int(round(np.sqrt(target_tris / 2)))
    verts, faces = torus_knot(2, 3, seg, seg)
    return normalize_to_unit(verts), faces
