"""Triangle meshes: the tensor container and the host-side numpy loaders
(OBJ, PLY) and generators.

Counterpart of `tpu_ray/scene/mesh.py`. The loaders and generators are
copies of the reference's numpy code (that module imports jax), so both
packages read and build bit-identical meshes. Normals are geometric,
computed at hit time.
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
# Loaders and generators (host-side numpy, copied from the reference)
# ---------------------------------------------------------------------------

def load_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Minimal OBJ parser: v / f lines, polygon faces triangulated as fans."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) for p in parts[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int32)


def load_ply(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Minimal PLY parser: ascii and binary_little_endian, vertex x/y/z
    properties + triangulated (fan) face lists — enough for Stanford scans."""
    import struct as _struct

    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a PLY file")
        fmt = None
        elements = []  # (name, count, [(type, prop)...])
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unterminated PLY header")
            parts = line.decode("ascii", "replace").split()
            if not parts or parts[0] == "comment":
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                elements[-1][2].append(tuple(parts[1:]))
            elif parts[0] == "end_header":
                break

        _SZ = {"char": "b", "uchar": "B", "int8": "b", "uint8": "B",
               "short": "h", "ushort": "H", "int16": "h", "uint16": "H",
               "int": "i", "uint": "I", "int32": "i", "uint32": "I",
               "float": "f", "float32": "f", "double": "d", "float64": "d"}
        verts, faces = [], []
        for name, count, props in elements:
            is_vert = name == "vertex"
            is_face = name == "face"
            if fmt == "ascii":
                for _ in range(count):
                    vals = f.readline().split()
                    if is_vert:
                        verts.append([float(v) for v in vals[:3]])
                    elif is_face:
                        n = int(vals[0])
                        idx = [int(v) for v in vals[1:1 + n]]
                        for k in range(1, n - 1):
                            faces.append([idx[0], idx[k], idx[k + 1]])
            else:  # binary_little_endian
                for _ in range(count):
                    row = []
                    for prop in props:
                        if prop[0] == "list":
                            n = _struct.unpack(
                                "<" + _SZ[prop[1]],
                                f.read(_struct.calcsize(_SZ[prop[1]])))[0]
                            item = _SZ[prop[2]]
                            idx = _struct.unpack(
                                "<" + item * n, f.read(_struct.calcsize(item) * n))
                            if is_face:
                                for k in range(1, n - 1):
                                    faces.append([idx[0], idx[k], idx[k + 1]])
                        else:
                            row.append(_struct.unpack(
                                "<" + _SZ[prop[0]],
                                f.read(_struct.calcsize(_SZ[prop[0]])))[0])
                    if is_vert:
                        verts.append(row[:3])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int32)


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


def icosphere(subdiv: int = 3, radius: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """Subdivided icosahedron: 20 * 4^subdiv triangles."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
         [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
         [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    faces = np.array(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int32)
    for _ in range(subdiv):
        edge_mid: dict[tuple[int, int], int] = {}
        new_faces = []
        vlist = list(verts)

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = vlist[a] + vlist[b]
                m /= np.linalg.norm(m)
                edge_mid[key] = len(vlist)
                vlist.append(m)
            return edge_mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int32)
    return verts * radius, faces


def bunny_standin(target_tris: int = 69938) -> tuple[np.ndarray, np.ndarray]:
    """~70k-triangle (2,3) torus-knot tube standing in for the Stanford bunny,
    scaled to a unit half-extent."""
    seg = int(round(np.sqrt(target_tris / 2)))
    verts, faces = torus_knot(2, 3, seg, seg)
    return normalize_to_unit(verts), faces
